"""Smoke run of prost_tpu on NVIDIA GPUs: the quickest proof that the system
starts, compiles and solves correctly on the card.

    python chip_smoke.py          one card: the card-only tests, then every
                                  structure at its bench.py cell size
    python chip_smoke.py --four   four cards: only the sharded (sp) and
                                  batched (dp) mesh paths, each against the
                                  same program on one card

Every phase prints its size, compile seconds, time per iteration (labelled
with the card), peak device memory and its comparison with the plain
reference: the same generic program on the CPU device of this process.

* ``stepsize="alg1"`` (constant steps): after the same N iterations, the
  relative L2 distance of x and y to the CPU run must be <= 1e-4.
* The bench's own options (adaptive steps): solve to the cell's tolerance on
  both devices and compare the primal energy, <= 1e-4 relative.  Iterates
  are not compared there: an adaptive scheme may branch differently after
  a last-bit difference.  Where the cell has no tolerance or the CPU
  needs too many iterations to reach it, the phase says so and compares
  the alg1 iterates only.

Any failure raises, and the script exits non-zero without its result line.
The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the repo root must be importable first)
from bench import card_name, require_gpu  # noqa: E402

REL_TOL = 1e-4      # alg1 iterates vs the CPU run
ENERGY_TOL = 1e-4   # primal energy after a solve vs the CPU run

# bench cell -> (alg1 iterations compared with the CPU run, tolerance of
# the energy comparison, iteration cap of that solve).  The tolerance is
# the cell's stopping rule (bench.py, phase 2), or None where the cell has
# none or the CPU reference needs too many iterations to reach it (ROF's
# 1e-6/px gap takes 30k, TV-L1's 1e-7 100k).
CHECKS = {
    "rof512_pdhg_iters_per_sec": (200, None, 0),
    "tvl1_512_pdhg_iters_per_sec": (200, None, 0),
    "deblur512_pdhg_iters_per_sec": (200, 1e-4, 20_000),
    "admm512_iters_per_sec": (50, 1e-4, 5_000),
    "multilabel256x8_pdhg_iters_per_sec": (200, 1e-5, 20_000),
    "tight128x4_pdhg_iters_per_sec": (200, 2e-6, 20_000),
    "ensemble1024x128_instance_iters_per_sec": (100, None, 0),
    "vol8x256_pdhg_iters_per_sec": (200, None, 0),
    "rof2048_pdhg_iters_per_sec": (50, None, 0),
    "multilabel512x8_pdhg_iters_per_sec": (50, None, 0),
    "admm2048_iters_per_sec": (20, None, 0),
}
ENSEMBLE_CHECKED = 8  # instances of the ensemble compared with the CPU


def run_gpu_tests():
    """The tests marked ``gpu``, in a child process that has the card to
    itself (this process has not touched JAX yet)."""
    env = dict(os.environ, PROST_TESTS_ON_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-q", "-m", "gpu",
         "-p", "no:cacheprovider"],
        cwd=ROOT, env=env, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit "
                           f"{r.returncode})")


# ---------------------------------------------------------------------------
# primal energies (float64, on the host), one per structure
# ---------------------------------------------------------------------------

def _find(proxs, cls, **attrs):
    return next(p for p in proxs if isinstance(p, cls)
                and all(getattr(p, k) == v for k, v in attrs.items()))


def _group_norms(v, comps):
    """Sum of the L2 norms of the planar groups of ``v`` (comps, count)."""
    return float(np.sqrt((v.reshape(comps, -1) ** 2).sum(axis=0)).sum())


def energy_denoise(problem, x, kx):
    """ROF (lmb/2 ||x-f||^2) or TV-L1 (lmb ||x-f||_1) plus (2D or 3D) TV."""
    from prost_tpu.prox import ProxElem1D

    p = _find(problem.prox_g, ProxElem1D)
    f, lmb = np.asarray(p.coeffs[1], np.float64), float(p.coeffs[2])
    r = x - f
    data = 0.5 * r @ r if p.fun == "square" else np.abs(r).sum()
    return lmb * data + _group_norms(kx, kx.size // x.size)


def energy_deblur(problem, x, kx):
    """lmb/2 ||B x - fb||^2 + TV(x); K = [B; grad]."""
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2

    pv = _find(problem.prox_f, ProxElem1D)
    pg = _find(problem.prox_f, ProxElemNorm2)
    fb, lmb = np.asarray(pv.coeffs[1], np.float64), float(pv.coeffs[2])
    r = kx[pv.index:pv.index + pv.size] - fb
    return 0.5 * lmb * r @ r + _group_norms(
        kx[pg.index:pg.index + pg.size], pg.dim)


def energy_labels(problem, x, kx):
    """<f, u> + lmb * sum of group norms: the fast multilabel relaxation
    (groups = the 2L gradient components of a pixel, K rows) and the tight
    one (groups = the 2 components of each pairwise variable v, x rows).
    lmb is the radius of the dual ball, ||q|| <= 1/a."""
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2

    pu = _find(problem.prox_g, ProxElem1D, fun="ind_geq0")
    f = np.asarray(pu.coeffs[3], np.float64)
    ball = _find(problem.prox_fstar, ProxElemNorm2)
    lmb = 1.0 / float(ball.coeffs[0])
    if x.size > f.size:  # tight: x = [u; v], the ball is v's dual
        groups = x[f.size:]
    else:
        groups = kx[ball.index:ball.index + ball.size]
    return f @ x[:f.size] + lmb * _group_norms(groups, ball.dim)


ENERGY = {
    "deblur512_pdhg_iters_per_sec": energy_deblur,
    "admm512_iters_per_sec": energy_denoise,
    "multilabel256x8_pdhg_iters_per_sec": energy_labels,
    "tight128x4_pdhg_iters_per_sec": energy_labels,
}


# ---------------------------------------------------------------------------
# comparisons with the CPU run
# ---------------------------------------------------------------------------

def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(label, value, tol, what):
    ok = value <= tol
    print(f"  {label}: {what} = {value:.3e} (tol {tol:.0e}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise RuntimeError(f"{label}: {what} {value:.3e} > {tol:.0e}")


def zero_tol_opts():
    import prost_tpu as pt

    return pt.SolverOptions(verbose=False, tol_rel_primal=0.0,
                            tol_rel_dual=0.0, tol_abs_primal=0.0,
                            tol_abs_dual=0.0)


def tol_opts(tol):
    import prost_tpu as pt

    return pt.SolverOptions(verbose=False, tol_rel_primal=tol,
                            tol_rel_dual=tol, tol_abs_primal=tol,
                            tol_abs_dual=tol)


def constant_step_variant(backend):
    """The backend's problem under constant steps (PDHG alg1) or a fixed
    rho (ADMM with zero tolerances never adapts) and zero tolerances."""
    from prost_tpu.backend import BackendADMM, BackendPDHG, PDHGOptions

    if isinstance(backend, BackendADMM):
        return lambda problem: BackendADMM(problem, backend.opts,
                                           zero_tol_opts())
    alg1 = PDHGOptions(stepsize="alg1", residual_iter=10,
                       scale_steps_operator=False)
    return lambda problem: BackendPDHG(problem, alg1, zero_tol_opts())


def run_iters(backend, iters):
    import jax

    return jax.block_until_ready(backend.run(backend.initial_state(), iters))


def run_iterates(backend, iters):
    """(x, y) as host arrays after ``iters`` iterations from the start."""
    x, _, y, _ = backend.current_solution(run_iters(backend, iters))
    return np.asarray(x), np.asarray(y)


def compare_alg1(name, backend, iters, cpu):
    """x, y after ``iters`` constant-step iterations on the card and on
    the CPU."""
    import jax

    make = constant_step_variant(backend)
    gx, gy = run_iterates(make(backend.problem), iters)
    cpu_problem = jax.device_put(backend.problem, cpu)
    with jax.default_device(cpu):
        cx, cy = run_iterates(make(cpu_problem), iters)
    what = f"{iters} constant-step iterations vs CPU, rel L2"
    check(name, rel_l2(gx, cx), REL_TOL, what + " x")
    check(name, rel_l2(gy, cy), REL_TOL, what + " y")


def solve_energy(backend, tol, cap, energy, cpu):
    """Energy of x after a solve to ``tol`` with ``backend``'s own options,
    plus the iterations taken and whether it converged."""
    import jax
    import jax.numpy as jnp

    b = type(backend)(backend.problem, backend.opts, tol_opts(tol))
    s = run_iters(b, cap)
    x = np.asarray(b.current_solution(s)[0], np.float64)
    cpu_problem = jax.device_put(backend.problem, cpu)
    with jax.default_device(cpu):
        kx = cpu_problem.linop.apply(jnp.asarray(x, jnp.float32))
        kx = np.asarray(kx, np.float64)
    return (energy(backend.problem, x, kx), int(np.asarray(s.iteration)),
            bool(np.asarray(s.converged)))


def compare_energy(name, backend, tol, cap, energy, cpu):
    import jax

    eg, ig, cg = solve_energy(backend, tol, cap, energy, cpu)
    cpu_backend = type(backend)(jax.device_put(backend.problem, cpu),
                                backend.opts, backend.solver_opts)
    with jax.default_device(cpu):
        ec, ic, cc = solve_energy(cpu_backend, tol, cap, energy, cpu)
    print(f"  {name}: solve to tol {tol:.0e} with the bench options: card "
          f"{ig} its (converged {cg}), CPU {ic} its (converged {cc}); "
          f"energy card {eg:.10g}, CPU {ec:.10g}", flush=True)
    if not (cg and cc):
        raise RuntimeError(f"{name}: solve to {tol:.0e} did not converge "
                           f"within {cap} iterations")
    check(name, abs(eg - ec) / abs(ec), ENERGY_TOL,
          "primal energy vs CPU, relative")


def compare_ensemble(name, batched, iters, cpu):
    """The first ENSEMBLE_CHECKED instances of the batched constant-step
    run against a CPU ensemble of just those instances."""
    import jax

    from prost_tpu.backend import PDHGOptions
    from prost_tpu.parallel import BatchedPDHG

    alg1 = PDHGOptions(stepsize="alg1", residual_iter=10,
                       scale_steps_operator=False)
    problems = unstack(batched.batched_problem, batched.batch)
    g = BatchedPDHG(problems, alg1, zero_tol_opts())
    gx, gy = (v[:ENSEMBLE_CHECKED] for v in run_iterates(g, iters))
    k = ENSEMBLE_CHECKED
    with jax.default_device(cpu):
        c = BatchedPDHG([jax.device_put(p, cpu) for p in problems[:k]],
                        alg1, zero_tol_opts())
        cx, cy = run_iterates(c, iters)
    what = (f"instances 0..{k - 1} of {batched.batch}, {iters} "
            "constant-step iterations vs CPU, rel L2")
    check(name, rel_l2(gx, cx), REL_TOL, what + " x")
    check(name, rel_l2(gy, cy), REL_TOL, what + " y")


def unstack(batched_problem, batch):
    import jax

    return [jax.tree.map(lambda leaf, i=i: leaf[i], batched_problem)
            for i in range(batch)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def time_backend(backend, short, long_):
    """(compile + warm-up seconds, seconds per iteration) from one
    two-point sweep of bench.TwoPointMeter."""
    t0 = time.perf_counter()
    meter = bench.TwoPointMeter(backend, short, long_)
    compile_s = time.perf_counter() - t0
    meter.sweep()
    return compile_s, 1.0 / meter.result()["value"]


def phase_quickstart(card, n, cpu, device):
    """README quick-start through pt.solve: ROF n x n, boyd steps."""
    import jax

    import prost_tpu as pt
    from prost_tpu import block, function

    lmb = 16.0
    f = np.random.RandomState(0).rand(n * n)

    def solve():
        u = pt.Variable(n * n)
        q = pt.Variable(2 * n * n)
        prob = pt.MinMaxProblem([u], [q])
        prob.add_function(u, function.sum_1d("square", 1, f, lmb))
        prob.add_function(q, function.conjugate(
            function.sum_norm2(2, False, "abs")))
        prob.add_dual_pair(u, q, block.gradient2d(n, n, 1))
        t0 = time.perf_counter()
        res = pt.solve(prob, pt.backend_pdhg(stepsize="boyd"),
                       pt.options(max_iters=10000, verbose=False))
        dt = time.perf_counter() - t0
        core = prob.finalize()
        x = np.asarray(u.val, np.float64)
        with jax.default_device(cpu):
            kx = np.asarray(jax.device_put(core, cpu).linop.apply(
                np.asarray(x, np.float32)), np.float64)
        return res, dt, energy_denoise(core, x, kx)

    name = f"quickstart ROF {n}x{n} (pt.solve, backend_pdhg boyd, tol 1e-4)"
    res, dt, eg = solve()
    print(f"[{name}] {res.iterations} its, {res.result.value}, "
          f"{dt:.3f} s wall including compile on {card}; peak device "
          f"memory {peak_bytes(device)} B", flush=True)
    if res.result != pt.ConvergenceResult.CONVERGED:
        raise RuntimeError(f"{name}: did not converge ({res.result})")
    with jax.default_device(cpu):
        res_c, _, ec = solve()
    print(f"  CPU: {res_c.iterations} its, {res_c.result.value}; energy "
          f"card {eg:.10g}, CPU {ec:.10g}", flush=True)
    check(name, abs(eg - ec) / abs(ec), ENERGY_TOL,
          "primal energy vs CPU, relative")


def phase_cell(card, config, cpu, device):
    """One bench cell: build, time, compare with the CPU."""
    name, builder, short, long_, _ = config
    iters, tol, cap = CHECKS[name]
    backend = builder()
    compile_s, s_per_it = time_backend(backend, short, long_)
    batch = getattr(backend, "batch", 1)
    size = (f"{batch} instances" if batch > 1 else
            f"{backend.problem.ncols} primal x {backend.problem.nrows} "
            "dual variables")
    print(f"[{name}] {size}: compile + warm-up {compile_s:.3f} s, "
          f"{s_per_it * 1e6:.3f} us/iteration ({1.0 / s_per_it:.1f} it/s"
          f"{' per batch step' if batch > 1 else ''}) on {card}; peak "
          f"device memory {peak_bytes(device)} B", flush=True)
    if batch > 1:
        compare_ensemble(name, backend, iters, cpu)
        return
    compare_alg1(name, backend, iters, cpu)
    if tol is None:
        print(f"  {name}: no energy comparison (the cell has no "
              "tolerance, or the CPU reference needs too many iterations "
              "to reach it); alg1 iterates only", flush=True)
    else:
        compare_energy(name, backend, tol, cap, ENERGY[name], cpu)


def one_card(card):
    import jax

    from prost_tpu.config import use_compile_cache

    device_rec = require_gpu()
    use_compile_cache()
    cpu = jax.devices("cpu")[0]
    device = jax.devices()[0]
    t0 = time.perf_counter()
    phase_quickstart(card, 512, cpu, device)
    print(f"  (phase wall time {time.perf_counter() - t0:.1f} s)", flush=True)
    for config in bench._all_configs():
        t0 = time.perf_counter()
        phase_cell(card, config, cpu, device)
        print(f"  (phase wall time {time.perf_counter() - t0:.1f} s)",
              flush=True)
    return device_rec


def four_cards(card, rof_n=2048, batch=1024, inst=128, iters=200):
    """ShardedPDHG over a 4-card 'sp' mesh (ROF rof_n^2) and BatchedPDHG
    over a 4-card 'dp' mesh (batch x inst^2), each against the same
    constant-step program on one card, plus both timed with the bench
    options."""
    import jax

    from prost_tpu.backend import BackendPDHG, PDHGOptions
    from prost_tpu.config import use_compile_cache
    from prost_tpu.parallel import BatchedPDHG, ShardedPDHG, make_mesh

    device_rec = require_gpu()
    if device_rec["count"] != 4:
        raise RuntimeError(f"--four needs 4 cards, have "
                           f"{device_rec['count']}")
    use_compile_cache()
    device = jax.devices()[0]
    alg1 = PDHGOptions(stepsize="alg1", residual_iter=10,
                       scale_steps_operator=False)
    popts = bench._pdhg_opts()

    # sp: one big problem, pixel axis over four cards
    name = f"rof{rof_n} ShardedPDHG over 4 cards (sp)"
    _, prob = bench.build_rof(rof_n, rof_n)
    sp_mesh = make_mesh((4,), axis_names=("sp",))
    one = BackendPDHG(prob, alg1, zero_tol_opts())
    four = ShardedPDHG(prob, alg1, zero_tol_opts(), mesh=sp_mesh)
    x1, y1 = run_iterates(one, iters)
    x4, y4 = run_iterates(four, iters)
    what = f"{iters} constant-step iterations vs one card, rel L2"
    check(name, rel_l2(x4, x1), REL_TOL, what + " x")
    check(name, rel_l2(y4, y1), REL_TOL, what + " y")
    for label, b in [("one card", BackendPDHG(prob, popts, zero_tol_opts())),
                     ("four cards", ShardedPDHG(prob, popts,
                                                zero_tol_opts(),
                                                mesh=sp_mesh))]:
        compile_s, s_per_it = time_backend(b, 200, 2200)
        print(f"  {name}: {label}: compile + warm-up {compile_s:.3f} s, "
              f"{s_per_it * 1e6:.3f} us/iteration on {card}; peak "
              f"device memory (card 0) {peak_bytes(device)} B", flush=True)
    del one, four, prob

    # dp: instances over four cards
    name = f"ensemble{batch}x{inst} BatchedPDHG over 4 cards (dp)"
    single = bench.build_ensemble(batch, inst, inst, popts=alg1)
    problems = unstack(single.batched_problem, batch)
    dp_mesh = make_mesh((4,), axis_names=("dp",))
    multi = BatchedPDHG(problems, alg1, zero_tol_opts(), mesh=dp_mesh)
    x1, y1 = run_iterates(single, iters)
    x4, y4 = run_iterates(multi, iters)
    what = (f"all {batch} instances, {iters} constant-step iterations vs "
            "one card, rel L2")
    check(name, rel_l2(x4, x1), REL_TOL, what + " x")
    check(name, rel_l2(y4, y1), REL_TOL, what + " y")
    for label, mesh in [("one card", None), ("four cards", dp_mesh)]:
        b = BatchedPDHG(problems, popts, zero_tol_opts(), mesh=mesh)
        compile_s, s_per_it = time_backend(b, 100, 1100)
        print(f"  {name}: {label}: compile + warm-up {compile_s:.3f} s, "
              f"{s_per_it * 1e6:.3f} us per batch step on {card}; peak "
              f"device memory (card 0) {peak_bytes(device)} B", flush=True)
    return device_rec


def main(argv):
    four = "--four" in argv
    card = card_name()
    print(card, flush=True)
    card = card.replace("\n", " | ")
    if four:
        device = four_cards(card)
    else:
        run_gpu_tests()
        device = one_card(card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
