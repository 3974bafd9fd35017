"""Volumetric TV denoising on an (L, nx, ny) grid with gradient3d.

The reference ships BlockGradient3D as a first-class operator
(/root/reference/src/linop/block_gradient3d.cu:153-174) but no 3D
example; this one denoises a stack of L noisy slices jointly:

    min_u  lmb/2 ||u - f||^2 + ||grad3 u||_{2,1}

where grad3 couples x/y (Neumann) and the slice axis (Dirichlet far
boundary).

Usage: python examples/example_vol_tv.py [--size N] [--slices L] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import add_std_args, setup_jax, synthetic_image


def run(size=64, L=8, max_iters=10000, verbose=True):
    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = L * nx * ny
    lmb = 8.0
    rng = np.random.RandomState(42)
    # a smoothly drifting stack of slices + noise
    base = synthetic_image(ny, nx, 1)[..., 0]
    stack = np.stack([np.roll(base, s, axis=0) for s in range(L)], axis=0)
    f = (stack + 0.08 * rng.randn(L, nx, ny)).reshape(-1)

    u = pt.Variable(n)
    q = pt.Variable(3 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(
        q, function.conjugate(function.sum_norm2(3, False, "abs")))
    prob.add_dual_pair(u, q, block.gradient3d(nx, ny, L))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-5, tol_rel_dual=1e-5,
        tol_abs_primal=1e-5, tol_abs_dual=1e-5,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    vol = u.val.reshape(L, nx, ny)
    noise_in = float(np.abs(f.reshape(L, nx, ny) - stack).mean())
    noise_out = float(np.abs(vol - stack).mean())
    if verbose:
        print(f"solved in {dt:.3f}s, {res.iterations} its, "
              f"{res.result.value}")
        print(f"mean abs error vs clean stack: {noise_in:.4f} -> "
              f"{noise_out:.4f}")
    return {"u": u.val, "f": f, "clean": stack, "noise_in": noise_in,
            "noise_out": noise_out, "iterations": res.iterations,
            "result": res.result}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=64)
    ap.add_argument("--slices", type=int, default=8)
    args = ap.parse_args()
    setup_jax(cpu=args.cpu)
    run(size=args.size, L=args.slices, max_iters=args.max_iters or 10000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
