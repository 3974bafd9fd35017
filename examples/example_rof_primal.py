"""ROF denoising in constrained (min_problem) form, with sub-variables.

Python counterpart of /root/reference/matlab/examples/example_rof_primal.m:

    min_{u,g}  lmb/2 ||u - f||^2 + ||g||_{2,1}   s.t.  g = grad u

demonstrating sub-variable partitioning of the data term (the reference
splits u into three sub-variables, example_rof_primal.m:19-26).

Usage: python examples/example_rof_primal.py [--size N] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import (add_std_args, fixture_or_synthetic, flatten_image,
                     setup_jax)


def run(size=128, max_iters=5000, verbose=True, image="lion"):
    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = nx * ny
    lmb = 10.0
    rng = np.random.RandomState(42)
    # the reference denoises lion.png (example_rof_primal.m:3)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    g = pt.Variable(2 * n)
    # sub-variables partition u; each carries its own slice of the data term
    # (the reference uses fixed splits 100/500/rest; scale to the image)
    n1, n2 = max(1, n // 8), max(1, n // 2)
    u1 = pt.SubVariable(u, n1)
    u2 = pt.SubVariable(u, n2)
    u3 = pt.SubVariable(u, n - n1 - n2)

    prob = pt.MinProblem([u], [g])
    prob.add_function(u1, function.sum_1d("square", 1, f[:n1], lmb))
    prob.add_function(u2, function.sum_1d("square", 1, f[n1:n1 + n2], lmb))
    prob.add_function(u3, function.sum_1d("square", 1, f[n1 + n2:], lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-6, tol_rel_dual=1e-6,
        tol_abs_primal=1e-6, tol_abs_dual=1e-6,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0
    if verbose:
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")

    assert u1.val.shape == (n1,) and np.allclose(u1.val, u.val[:n1])
    return {"u": u.val, "g": g.val, "iterations": res.iterations,
            "result": res.result, "f": f, "lmb": lmb}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    setup_jax(cpu=args.cpu)
    run(size=args.size, max_iters=args.max_iters or 5000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
