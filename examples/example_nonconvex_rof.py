"""Nonconvex ROF: Mumford-Shah (truncated quadratic) regularizer.

Python counterpart of
/root/reference/matlab/examples/example_nonconvex_rof.m:

    min_u  1/2 ||u - f||^2 + sum_i min(alpha ||grad u_i||^2, lambda)

solved with the accelerated (alg2) PDHG and the conjugate of the truncquad
norm2 function (the nonconvex prox is handled pointwise in closed form,
function_1d.hpp:273-291).

Usage: python examples/example_nonconvex_rof.py [--size N] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import (add_std_args, fixture_or_synthetic, flatten_image,
                     setup_jax)


def run(size=128, max_iters=2000, verbose=True, image="house"):
    import jax.numpy as jnp

    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = nx * ny
    rng = np.random.RandomState(42)
    # piecewise-constant subject (house-facade fixture): the class of
    # image truncated-quadratic regularizers are built for
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    lam, alpha = 0.05, 30.0

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, 1))
    prob.add_function(q, function.conjugate(
        function.sum_norm2(2, False, "truncquad", 1, 0, 1, 0, 0, alpha, lam)
    ))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        x0=np.zeros(n),
    )
    backend = pt.backend_pdhg(stepsize="alg2", residual_iter=10,
                              alg2_gamma=0.25)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    g = np.asarray(core.linop.apply(jnp.asarray(u.val, jnp.float32)))
    gn2 = g[:n] ** 2 + g[n:] ** 2
    energy = 0.5 * np.sum((u.val - f) ** 2) + np.sum(
        np.minimum(alpha * gn2, lam)
    )
    if verbose:
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"Mumford-Shah energy = {energy:.6f}")
    return {"u": u.val, "f": f, "energy": energy,
            "iterations": res.iterations}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    setup_jax(cpu=args.cpu)
    run(size=args.size, max_iters=args.max_iters or 2000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
