"""Multi-device solving: one big ROF problem with its pixel axis sharded.

No reference counterpart — the reference is single-GPU (SURVEY.md §2.8);
this demonstrates the framework's scale-out layer: ``ShardedPDHG`` puts
named shardings on the state vectors and lets XLA's SPMD partitioner place
the collectives (halo exchanges for the gradient stencils, all-reduces for
the residual norms).  The same problem also runs unsharded on one device,
and the two trajectories must agree.

Run on multi-device hardware as-is; on a single host, pass --virtual N
to emulate an N-device mesh on CPU (the same SPMD program, compiled for N
host devices — how the test suite validates the sharded path).

Usage: python examples/example_sharded.py [--size N] [--virtual N] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from _common import add_std_args, flatten_image, setup_jax, synthetic_image


def run(size=256, n_shards=None, max_iters=2000, verbose=True):
    import jax

    import prost_tpu as pt
    from prost_tpu import block, function
    from prost_tpu.backend.pdhg import BackendPDHG, PDHGOptions
    from prost_tpu.parallel import ShardedPDHG, make_mesh

    n_shards = n_shards or len(jax.devices())
    mesh = make_mesh((n_shards,), axis_names=("sp",))

    nx = ny = size
    n = nx * ny
    lmb = 16.0
    rng = np.random.RandomState(42)
    f = flatten_image(synthetic_image(ny, nx, 1)) + 0.05 * rng.randn(n)

    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d("square", 1, f, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    core = prob.finalize()

    popts = PDHGOptions(stepsize="boyd", residual_iter=10,
                        scale_steps_operator=False)
    sopts = pt.SolverOptions(verbose=False, tol_rel_primal=1e-5,
                             tol_rel_dual=1e-5, tol_abs_primal=1e-5,
                             tol_abs_dual=1e-5)

    results = {}
    for name, make in [
        (f"sharded over {n_shards} devices (ShardedPDHG)",
         lambda: ShardedPDHG(core, popts, sopts, mesh=mesh)),
        ("one device (BackendPDHG)",
         lambda: BackendPDHG(core, popts, sopts)),
    ]:
        backend = make()
        state = backend.initial_state()
        t0 = time.time()
        state = backend.run(state, max_iters)
        jax.block_until_ready(state.x)
        dt = time.time() - t0
        it = int(np.asarray(state.iteration))
        results[name] = np.asarray(state.x)
        if verbose:
            print(f"{name}: {it} its in {dt:.3f}s ({it / dt:.0f} it/s), "
                  f"primal res {float(state.primal_residual):.3e}")

    sharded, single = results.values()
    diff = float(np.max(np.abs(sharded - single)))
    if verbose:
        print(f"max |sharded - one device| = {diff:.2e} (same algorithm, "
              "same trajectory)")
    return {"u": sharded, "diff": diff, "n_shards": n_shards}


def main():
    ap = add_std_args(argparse.ArgumentParser(), size=256)
    ap.add_argument("--virtual", type=int, default=None,
                    help="emulate N devices on host CPU")
    args = ap.parse_args()
    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
    setup_jax(cpu=args.cpu or bool(args.virtual))
    run(size=args.size, n_shards=args.virtual,
        max_iters=args.max_iters or 2000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
