"""TV inpainting with a masked quadratic data term.

Python counterpart of /root/reference/matlab/examples/example_tv_inpaint.m:

    min_u  lmb/2 ||m .* (u - f)||^2 + ||grad u||_{2,1}

where m is a 0/1 mask (the data term vanishes on masked pixels, which get
pure TV inpainting).  Demonstrates per-element coefficient broadcast in
sum_1d (coefficient a = m, example_tv_inpaint.m:22).

Usage: python examples/example_tv_inpaint.py [--size N] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import (add_std_args, fixture_or_synthetic, flatten_image,
                     setup_jax, load_fixture_image)


def run(size=128, max_iters=50000, verbose=True, image="lion"):
    import jax.numpy as jnp

    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = nx * ny
    lmb = 7.0
    rng = np.random.RandomState(42)
    # the reference inpaints lion.png under the maske2.png scribble mask
    # (example_tv_inpaint.m:5-10: m = 1 - (mask > 0), so the data term
    # vanishes exactly on the white strokes)
    f = flatten_image(fixture_or_synthetic(image, ny, nx, 1)) \
        + 0.02 * rng.randn(n)
    if image == "synthetic":
        # mask: drop a band plus random 30% of pixels (maske2.png role)
        m = np.ones(n)
        m[rng.rand(n) < 0.3] = 0.0
        band = ((np.arange(n) // ny % nx > nx // 3)
                & (np.arange(n) // ny % nx < nx // 3 + 3))
        m[band] = 0.0
    else:
        mask = load_fixture_image("maske2", size=(ny, nx))
        m = 1.0 - flatten_image((mask > 0.5)[..., None].astype(np.float64))

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", m, f * m, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-7, tol_rel_dual=1e-7,
        tol_abs_primal=1e-7, tol_abs_dual=1e-7,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    core = prob.finalize()
    g = np.asarray(core.linop.apply(jnp.asarray(u.val, jnp.float32)))
    energy = lmb / 2 * np.sum((m * (u.val - f)) ** 2) + np.sum(
        np.sqrt(g[:n] ** 2 + g[n:] ** 2)
    )
    if verbose:
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"energy_pd = {energy:.6f}")
    return {"u": u.val, "f": f, "mask": m, "energy": energy,
            "iterations": res.iterations, "lmb": lmb}


def main():
    args = add_std_args(argparse.ArgumentParser()).parse_args()
    setup_jax(cpu=args.cpu)
    run(size=args.size, max_iters=args.max_iters or 50000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
