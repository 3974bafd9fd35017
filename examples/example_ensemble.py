"""Batched ROF ensemble: many problem instances solved as one SPMD program.

The capability the single-GPU reference lacks (SURVEY.md section 2.8 /
BASELINE config 5): B independent ROF instances (different noisy images)
run as a single vmapped PDHG program, batch axis sharded over the device
mesh ('dp').  On one chip this measures batched throughput; on a slice it
scales with the mesh.

Usage: python examples/example_ensemble.py [--size N] [--batch B] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import add_std_args, setup_jax, synthetic_image, flatten_image


def build_problems(size, batch, lmb=16.0):
    import prost_tpu as pt
    from prost_tpu.linop import BlockGradient2D, LinearOperator
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    ny = nx = size
    n = nx * ny
    base = flatten_image(synthetic_image(ny, nx, 1))
    rng = np.random.RandomState(0)
    problems = []
    for _ in range(batch):
        f = (base + 0.05 * rng.randn(n)).astype(np.float32)
        grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
        prox_g = [ProxElem1D(index=0, size=n, fun="square",
                             coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
        pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                           interleaved=False, fun="abs",
                           coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
        problems.append(pt.Problem.create(
            LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ProxMoreau(index=0, size=2 * n, child=pn)]))
    return problems


def run(size=64, batch=16, iters=500, verbose=True):
    import jax

    import prost_tpu as pt
    from prost_tpu.backend.pdhg import PDHGOptions
    from prost_tpu.parallel import BatchedPDHG, make_mesh

    problems = build_problems(size, batch)
    mesh = None
    ndev = len(jax.devices())
    if ndev > 1 and batch % ndev == 0:
        mesh = make_mesh((ndev,), axis_names=("dp",))

    solver = BatchedPDHG(
        problems,
        PDHGOptions(stepsize="boyd", residual_iter=10,
                    scale_steps_operator=False),
        pt.SolverOptions(verbose=False, tol_rel_primal=0, tol_rel_dual=0,
                         tol_abs_primal=0, tol_abs_dual=0),
        mesh=mesh,
    )
    state = solver.initial_state()
    state = solver.run(state, 10)
    assert int(np.asarray(state.iteration)[0]) == 10  # sync + sanity

    t0 = time.perf_counter()
    state = solver.run(state, 10 + iters)
    done = int(np.asarray(state.iteration)[0])  # host read = sync
    dt = time.perf_counter() - t0
    assert done == 10 + iters

    inst_iters_per_sec = batch * iters / dt
    if verbose:
        print(f"{batch} instances x {iters} iterations in {dt:.3f}s")
        print(f"batched throughput: {inst_iters_per_sec:,.0f} "
              f"instance-iterations/s "
              f"({'sharded over ' + str(ndev) + ' devices' if mesh else '1 device'})")
    x, z, y, w = solver.current_solution(state)
    return {"x": np.asarray(x), "throughput": inst_iters_per_sec,
            "devices": ndev if mesh else 1}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args()
    setup_jax(cpu=args.cpu)
    run(size=args.size, batch=args.batch, iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
