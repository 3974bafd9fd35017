"""Multilabel segmentation with the tight pairwise relaxation.

Python counterpart of
/root/reference/matlab/examples/example_multilabel_tight.m: on top of the
fast relaxation, pairwise Lagrange multipliers v_ij couple the dual q via
p_ij, expressed with kron-structured blocks (identity + sparse_kron_id,
example_multilabel_tight.m:78-88).

Usage: python examples/example_multilabel_tight.py [--size N] [--labels L] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import add_std_args, setup_jax, load_fixture_image, synthetic_image
from example_multilabel_fast import unaries


def pair_local_matrix(L):
    """(2k, 2L) pairwise difference matrix, k = L(L-1)/2
    (example_multilabel_tight.m:27-39)."""
    k = L * (L - 1) // 2
    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i] = 1.0
            P[idx, j] = -1.0
            P[idx + k, i + L] = 1.0
            P[idx + k, j + L] = -1.0
            idx += 1
    return P


def run(size=48, L=3, max_iters=20000, verbose=True, image=None):
    import prost_tpu as pt
    from prost_tpu import block, function

    ny = nx = size
    n = nx * ny
    lmb = 1.0
    k = L * (L - 1) // 2
    if image is not None:
        im = load_fixture_image(image, size=size)[..., None]
    else:
        im = synthetic_image(ny, nx, 1)
    f = unaries(im, L)
    P = pair_local_matrix(L)

    # primal: u (labels), v (pairwise multipliers)
    u = pt.Variable(n * L)
    v = pt.Variable(2 * n * k)
    # dual: q (gradient), p (pairwise), s (sum-to-one)
    q = pt.Variable(2 * n * L)
    p = pt.Variable(2 * n * k)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u, v], [q, p, s])

    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    # |p_ij| <= lmb per pixel-pair (2-dim vectors)
    prob.add_function(p, function.sum_norm2(2, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))

    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, block.identity())
    prob.add_dual_pair(v, q, block.sparse_kron_id(P.T, n))

    opts = pt.options(
        max_iters=max_iters, num_cback_calls=10, verbose=verbose,
        tol_rel_primal=2e-6, tol_rel_dual=2e-6,
        tol_abs_primal=2e-6, tol_abs_dual=2e-6,
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
    return {"u": u.val, "v": v.val, "labels": labels, "f": f, "lmb": lmb,
            "P": P, "iterations": res.iterations, "result": res.result}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=48)
    ap.add_argument("--labels", type=int, default=3)
    ap.add_argument("--image", type=str, default="cow",
                    help="fixture image name (data/<name>.png) or "
                         "'synthetic'")
    args = ap.parse_args()
    setup_jax(cpu=args.cpu)
    image = None if args.image == "synthetic" else args.image
    run(size=args.size, L=args.labels, max_iters=args.max_iters or 20000,
        image=image)
    return 0


if __name__ == "__main__":
    sys.exit(main())
