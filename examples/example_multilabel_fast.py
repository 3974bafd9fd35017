"""Multilabel TV segmentation, simplex-free ("fast") relaxation.

Python counterpart of /root/reference/matlab/examples/example_multilabel_fast.m
(Lellmann et al. relaxation with an explicit Lagrange multiplier s for the
sum-to-one constraint):

    min_{u >= 0} <u, f> + lmb TV(u)   s.t.  sum_l u_l = 1 per pixel

    saddle form:  min_u max_{q, s} <u,f> + I(u>=0)
                  + <grad u, q> - I(||q|| <= lmb)
                  + <sum_l u_l, s> - <s, 1>

Usage: python examples/example_multilabel_fast.py [--size N] [--labels L] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import add_std_args, setup_jax, load_fixture_image, synthetic_image


def unaries(im, L):
    """Quadratic unary potentials against L evenly spaced gray levels,
    flattened label-outermost (matching gradient2d label_first=False)."""
    ny, nx = im.shape[:2]
    gray = im.mean(axis=-1)
    means = np.linspace(0, 1, L)
    f = np.stack([(gray - m) ** 2 for m in means], axis=0)  # (L, ny, nx)
    return f.transpose(0, 2, 1).reshape(-1)  # l outermost, then x, then y


def run(size=64, L=8, max_iters=5000, verbose=True, image=None):
    """image="cow" segments the committed cow.png fixture (resized to
    size x size) — the BASELINE config 3 workload, 8 labels on cow.png
    (example_multilabel_fast.m:7-12); image=None keeps the synthetic
    test image."""
    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = nx * ny
    lmb = 0.5
    if image is not None:
        im = load_fixture_image(image, size=size)[..., None]
    else:
        im = synthetic_image(ny, nx, 1)
    f = unaries(im, L)

    u = pt.Variable(n * L)
    q = pt.Variable(2 * n * L)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])

    # I(u >= 0) + <u, f>
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    # I(||q_i||_2 <= lmb) via c*f(a|x|-b): a = 1/lmb, b = 1
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    # <s, -1>
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))

    # <grad u, q>
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    # <sum_l u_l, s> = kron(ones(1, L), I_n) u
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=1e-5, tol_rel_dual=1e-5,
        tol_abs_primal=1e-5, tol_abs_dual=1e-5,
    )
    backend = pt.backend_pdhg(stepsize="boyd", residual_iter=10)
    t0 = time.time()
    res = pt.solve(prob, backend, opts)
    dt = time.time() - t0

    labels = u.val.reshape(L, n)
    if verbose:
        print(f"solved in {dt:.3f}s, {res.iterations} its, {res.result.value}")
        print(f"per-pixel label sums: min={labels.sum(0).min():.4f} "
              f"max={labels.sum(0).max():.4f}")
    return {"u": u.val, "labels": labels, "f": f, "lmb": lmb,
            "iterations": res.iterations, "result": res.result}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=64)
    ap.add_argument("--labels", type=int, default=8)
    ap.add_argument("--image", type=str, default="cow",
                    help="fixture image name (data/<name>.png) or "
                         "'synthetic'")
    args = ap.parse_args()
    setup_jax(cpu=args.cpu)
    image = None if args.image == "synthetic" else args.image
    run(size=args.size, L=args.labels, max_iters=args.max_iters or 5000,
        image=image)
    return 0


if __name__ == "__main__":
    sys.exit(main())
