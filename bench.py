"""Benchmark harness: PDHG / ADMM iteration throughput on the GPU.

Prints ONE JSON line for ROF 512x512: {"metric": ..., "value": N, "unit":
..., "device": {...}, "card": ...}.  With --all, additionally measures the
other cells (TV-L1, deblurring, ADMM, multilabel, tight multilabel,
volumetric TV, the batched ensemble, and the 2048^2 / 512^2x8 sizes) and
seconds-to-tolerance at the reference's stopping rules, printing them to
STDERR, one JSON line each, keeping stdout to the single primary line.

Every record names the device it ran on; the run refuses to start when
JAX's first device is not a GPU.
"""

import json
import subprocess
import sys
import time

import numpy as np


def card_name():
    """The GPU's name and power limit as nvidia-smi reports them, one line
    per card (a card below its 700 W maximum runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The device record {platform, kind, count}; raises RuntimeError when
    JAX's first device is not a GPU (no measurement falls back to the
    CPU)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _solver_opts():
    import prost_tpu as pt

    return pt.SolverOptions(
        verbose=False,
        tol_rel_primal=0.0, tol_rel_dual=0.0,
        tol_abs_primal=0.0, tol_abs_dual=0.0,
    )


def _pdhg_opts():
    # residual_iter=10: measure the production configuration (the reference's
    # MATLAB examples run residual_iter=1, but 10 is its documented knob for
    # exactly this purpose, backend_pdhg.hpp:63-66).
    # scale_steps_operator=False skips the normest power iteration (the
    # alpha preconditioner already normalizes ||Sigma^1/2 K Tau^1/2|| ~ 1,
    # so tau0 = sigma0 = 1 is the operating point normest would pick)
    from prost_tpu.backend.pdhg import PDHGOptions

    return PDHGOptions(stepsize="boyd", residual_iter=10,
                       scale_steps_operator=False)


def _test_image(nx, ny, seed=42):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, nx)
    xx, yy = np.meshgrid(x, np.linspace(0, 1, ny), indexing="ij")
    im = 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.09) + 0.3 * (xx > 0.7)
    return (im + 0.05 * rng.randn(nx, ny)).astype(np.float32)


def build_rof(nx, ny, lmb=16.0, seed=42, dataterm="square", sopts=None,
              image="lion"):
    """ROF (square) or TV-L1 (abs) denoising.  Returns (backend, problem)."""
    import prost_tpu as pt
    from prost_tpu.backend import BackendPDHG
    from prost_tpu.linop import BlockGradient2D, LinearOperator
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    n = nx * ny
    f = _fixture_image(image, nx, ny, noise=0.05, seed=seed).reshape(-1)

    grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    linop = LinearOperator.create([grad])
    prox_g = [
        ProxElem1D(index=0, size=n, fun=dataterm,
                   coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))
    ]
    pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2, interleaved=False,
                       fun="abs", coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    prox_fstar = [ProxMoreau(index=0, size=2 * n, child=pn)]
    prob = pt.Problem.create(linop, prox_g=prox_g, prox_fstar=prox_fstar)
    return BackendPDHG(prob, _pdhg_opts(), sopts or _solver_opts()), prob


def _fixture_image(name, nx, ny, noise=0.0, seed=42):
    """A committed fixture image (data/<name>.png, data/make_fixtures.py)
    resized to (nx, ny), optionally with additive Gaussian noise (the
    denoising workloads measure on a noisy observation like the
    examples).  Every bench config draws from the fixture playing the
    same role as the image its reference example loads: rof/inpaint
    lion, tvl1 fisch, deblur flowers, multilabel cow (BASELINE config 3)
    and junction_gray (the reference multilabel subject,
    example_multilabel_fast.m:3), tight junction_gray, admm house, vol
    dog; "synthetic" keeps the procedural pattern."""
    if name == "synthetic":
        return _test_image(nx, ny, seed)
    import os

    from prost_tpu.util.images import load_image

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", f"{name}.png")
    out = load_image(path, (nx, ny))
    if noise:
        out = out + noise * np.random.RandomState(seed).randn(nx, ny)
    return out.astype(np.float32)


def build_multilabel(nx, ny, L=8, lmb=0.5, seed=42, sopts=None,
                     image="cow"):
    """Fast multilabel relaxation on the cow fixture (BASELINE config 3:
    8 labels on cow.png)."""
    import prost_tpu as pt
    from prost_tpu import block, function
    from prost_tpu.backend import BackendPDHG

    n = nx * ny
    gray = _fixture_image(image, nx, ny)
    means = np.linspace(0, 1, L)
    f = np.stack([(gray - m) ** 2 for m in means], axis=0).reshape(-1)
    f = f.astype(np.float32)

    u = pt.Variable(n * L)
    q = pt.Variable(2 * n * L)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    return BackendPDHG(prob.finalize(), _pdhg_opts(), sopts or _solver_opts())


def build_deblur(nx, ny, lmb=100.0, seed=42, klen=9, sopts=None):
    """TV deblurring: conv block + gradient block (the full BASELINE
    config 2 workload, example_deblurring.m)."""
    import prost_tpu as pt
    from prost_tpu import block, function
    from prost_tpu.backend import BackendPDHG

    # motion-blur kernel (examples/example_deblurring.py::motion_kernel)
    kern = np.zeros((klen, klen))
    c = (klen - 1) / 2
    t = np.deg2rad(45.0)
    for i in np.linspace(-c, c, 4 * klen):
        y, x = int(round(c + i * np.sin(t))), int(round(c + i * np.cos(t)))
        kern[y, x] = 1.0
    kern /= kern.sum()

    n = nx * ny
    ny2, nx2 = ny + klen - 1, nx + klen - 1
    rng = np.random.RandomState(seed)
    # the flowers fixture (the reference deblurring subject,
    # example_deblurring.m:3) blurred by the motion kernel
    # (example_deblurring.m applies B to the test image) + noise
    from scipy.signal import convolve2d

    clean = _fixture_image("flowers", nx, ny)
    f_blurred = (convolve2d(clean, kern, mode="full")
                 + 0.01 * rng.randn(nx2, ny2)).reshape(-1)

    u = pt.Variable(n)
    v = pt.Variable(nx2 * ny2)
    g = pt.Variable(2 * n)
    prob = pt.MinProblem([u], [v, g])
    prob.add_function(v, function.sum_1d("square", 1, f_blurred, lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, block.conv2d(nx, ny, 1, kern))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))
    return BackendPDHG(prob.finalize(), _pdhg_opts(), sopts or _solver_opts())


def build_tight(nx, ny, L=4, lmb=1.0, seed=42, sopts=None):
    """Tight multilabel relaxation (BASELINE config 3, the heavier
    variant: pairwise multipliers via kron(P^T, I_n) + identity blocks)."""
    import prost_tpu as pt
    from prost_tpu import block, function
    from prost_tpu.backend import BackendPDHG

    n = nx * ny
    k = L * (L - 1) // 2
    gray = _fixture_image("junction_gray", nx, ny)
    means = np.linspace(0, 1, L)
    f = np.stack([(gray - m) ** 2 for m in means], axis=0).reshape(-1)

    P = np.zeros((2 * k, 2 * L))
    idx = 0
    for i in range(L):
        for j in range(i + 1, L):
            P[idx, i], P[idx, j] = 1.0, -1.0
            P[idx + k, i + L], P[idx + k, j + L] = 1.0, -1.0
            idx += 1

    u = pt.Variable(n * L)
    v = pt.Variable(2 * n * k)
    q = pt.Variable(2 * n * L)
    p = pt.Variable(2 * n * k)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u, v], [q, p, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f, 0))
    prob.add_function(p, function.sum_norm2(2, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    prob.add_dual_pair(v, p, block.identity())
    prob.add_dual_pair(v, q, block.sparse_kron_id(P.T, n))
    return BackendPDHG(prob.finalize(), _pdhg_opts(), sopts or _solver_opts())


def build_vol(L, nx, ny, lmb=6.0, seed=42, sopts=None):
    """Volumetric TV on an (L, nx, ny) grid (BlockGradient3D).  The
    reference ships gradient3d as a first-class operator
    (block_gradient3d.cu) but no 3D example; this measures the operator
    family at multilabel-like cost."""
    import prost_tpu as pt
    from prost_tpu.linop import BlockGradient3D, LinearOperator
    from prost_tpu.backend import BackendPDHG
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    n = L * nx * ny
    rng = np.random.RandomState(seed)
    base = _fixture_image("dog", nx, ny)
    f = np.stack([base + 0.02 * rng.randn(nx, ny) for _ in range(L)],
                 axis=0).reshape(-1).astype(np.float32)
    grad = BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L)
    prox_g = [ProxElem1D(index=0, size=n, fun="square",
                         coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
    pn = ProxElemNorm2(index=0, size=3 * n, count=n, dim=3,
                       interleaved=False, fun="abs",
                       coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    prob = pt.Problem.create(
        LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ProxMoreau(index=0, size=3 * n, child=pn)])
    return BackendPDHG(prob, _pdhg_opts(), sopts or _solver_opts())


def build_ensemble(B, nx, ny, seed=42, popts=None):
    """B-instance ROF ensemble (BASELINE config 5) on one device: the
    vmapped PDHG step over a leading batch axis (parallel/ensemble.py).
    The reference has no batching — it solves instances one launch-bound
    solve at a time."""
    import prost_tpu as pt
    from prost_tpu.linop import BlockGradient2D, LinearOperator
    from prost_tpu.parallel import BatchedPDHG
    from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau

    n = nx * ny
    rng = np.random.RandomState(seed)
    base = _test_image(nx, ny, seed).reshape(-1)

    def one(i):
        f = (base + 0.05 * rng.randn(n)).astype(np.float32)
        lmb = float(rng.uniform(4.0, 32.0))
        grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
        prox_g = [ProxElem1D(index=0, size=n, fun="square",
                             coeffs=(1.0, f, lmb, 0.0, 0.0, 0.0, 0.0))]
        pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2,
                           interleaved=False, fun="abs",
                           coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
        return pt.Problem.create(
            LinearOperator.create([grad]), prox_g=prox_g,
            prox_fstar=[ProxMoreau(index=0, size=2 * n, child=pn)])

    problems = [one(i) for i in range(B)]
    return BatchedPDHG(problems, popts or _pdhg_opts(), _solver_opts())


class TwoPointMeter:
    """Two-point throughput measurement with dispersion: time a short and
    a long run of the SAME compiled program and report
    Delta-iters / Delta-t.  Dispatch and synchronization cost the same in
    both runs, so they cancel, leaving the device's time per iteration.
    Each run ends in ``jax.block_until_ready``.

    ``sweep()`` takes one (short, long) pair, so the --all mode can
    interleave configs round-robin; ``result()`` returns {value, min, max,
    n_sweeps}, ``value`` being the median of the per-sweep estimates.

    Warm up to iteration 21 (21 % residual_iter == 1 for residual_iter
    10, so every timed run starts at the same phase of the residual
    schedule).
    """

    def __init__(self, backend, short=2000, long_=22000):
        import jax

        self._block = jax.block_until_ready
        self.backend = backend
        self.short = short
        self.long_ = long_
        state = backend.initial_state()
        state = self._block(backend.run(state, 21))
        assert self._iteration(state) == 21
        self.state = state
        self.done = 21
        self.ests = []
        self.best_long = float("inf")

    @staticmethod
    def _iteration(s):
        return int(np.max(np.asarray(s.iteration)))  # scalar or (B,)

    def _timed_run(self, iters):
        t0 = time.perf_counter()
        self.state = self._block(
            self.backend.run(self.state, self.done + iters))
        dt = time.perf_counter() - t0
        assert self._iteration(self.state) == self.done + iters
        self.done += iters
        return dt

    def sweep(self):
        """One (short, long) timing pair; keeps the estimate only when the
        long run took clearly longer than the short one."""
        dt_s = self._timed_run(self.short)
        dt_l = self._timed_run(self.long_)
        self.best_long = min(self.best_long, dt_l)
        delta = dt_l - dt_s
        if delta >= 0.2 * dt_l:
            self.ests.append((self.long_ - self.short) / delta)

    def result(self):
        if not self.ests:
            # no usable pair: report the single-run rate of the fastest
            # long run (includes dispatch, so it underestimates)
            v = self.long_ / self.best_long
            return {"value": v, "min": v, "max": v, "n_sweeps": 0}
        return {"value": float(np.median(self.ests)),
                "min": min(self.ests), "max": max(self.ests),
                "n_sweeps": len(self.ests)}


def measure_backend(backend, short=2000, long_=22000, repeats=3):
    """Sequential-repeats wrapper around TwoPointMeter (the single-config
    default mode)."""
    meter = TwoPointMeter(backend, short, long_)
    for _ in range(repeats):
        meter.sweep()
    return meter.result()


def measure_iters_to_gap(nx=512, ny=512, lmb=16.0, gap_tol=1e-6,
                         check=5000, max_iters=500_000):
    """Iterations until the ROF primal-dual gap per pixel falls below
    gap_tol (the BASELINE.md headline: time-to-1e-6 gap on ROF 512x512).

    Energies follow example_rof_pdgap.m:4-15, accumulated in f64 on host
    from the f32 iterates; the dual iterate is feasible by construction
    (prox_{f*} projects onto the unit ball every iteration).  Runs in
    `check`-iteration chunks with one host gap check per chunk.  Returns
    None if max_iters is hit first (f32 gap floor).

    lmb is passed through to build_rof and reused in the energies, so the
    gap always measures the objective actually being solved.
    """
    import jax.numpy as jnp

    backend, prob = build_rof(nx, ny, lmb=lmb)
    n = nx * ny
    f = _fixture_image("lion", nx, ny, noise=0.05).reshape(-1).astype(
        np.float64)
    K = prob.linop

    state = backend.initial_state()
    it = 0
    while it < max_iters:
        it += check
        state = backend.run(state, it)
        x = np.asarray(state.x, np.float64)
        y = np.asarray(state.y, np.float64)
        g = np.asarray(K.apply(jnp.asarray(x, jnp.float32)), np.float64)
        ep = lmb / 2 * np.sum((x - f) ** 2) + np.sum(
            np.sqrt(g[:n] ** 2 + g[n:] ** 2))
        div = np.asarray(K.apply_adjoint(jnp.asarray(y, jnp.float32)),
                         np.float64)
        ed = f @ div - 1 / (2 * lmb) * np.sum(div ** 2)
        if (ep - ed) / n <= gap_tol:
            return it
    return None


def measure_iters_to_tol(make_backend, tol, check=2000, max_iters=200_000):
    """Iterations until the backend's own convergence test fires at the
    given relative+absolute tolerance — the reference's stopping rule
    (solver.cu:149, eps formulas backend.hpp:71-74).  ``make_backend``
    receives a SolverOptions carrying the tolerances.  Returns the
    iteration count or None if max_iters is hit (f32 residual floor)."""
    import prost_tpu as pt

    sopts = pt.SolverOptions(
        verbose=False,
        tol_rel_primal=tol, tol_rel_dual=tol,
        tol_abs_primal=tol, tol_abs_dual=tol,
    )
    backend = make_backend(sopts)
    state = backend.initial_state()
    it = 0
    while it < max_iters:
        it += check
        state = backend.run(state, it)
        done = int(np.asarray(state.iteration))
        if done < it or bool(np.asarray(state.converged)):
            return done
    return None


def measure_seconds_to_tol_direct(make_backend, tol, cap, repeats=4):
    """Directly measured run-to-convergence device seconds.

    The backend's while loop evaluates the convergence test on the device,
    so one ``run(state, cap)`` call with real tolerances executes exactly
    until convergence.  Per repeat, time that call AND a short run of the
    SAME compiled program (``until`` is a traced argument) from a fresh
    initial state; the difference cancels dispatch, leaving the device
    time from iteration 21 to convergence.  Returns (measurement,
    iterations, converged), the measurement being {value (median), min,
    max, n_sweeps} over repeats, or None if no repeat gave a positive
    difference."""
    import jax

    import prost_tpu as pt

    sopts = pt.SolverOptions(
        verbose=False,
        tol_rel_primal=tol, tol_rel_dual=tol,
        tol_abs_primal=tol, tol_abs_dual=tol,
    )
    backend = make_backend(sopts)

    def timed(until):
        t0 = time.perf_counter()
        s = jax.block_until_ready(backend.run(backend.initial_state(), until))
        return time.perf_counter() - t0, s

    # compile + warm both call shapes
    timed(21)
    _, s = timed(cap)
    iters = int(np.asarray(s.iteration))
    converged = bool(np.asarray(s.converged))

    ests = []
    for _ in range(repeats):
        t_short, _ = timed(21)
        t_conv, _ = timed(cap)
        if t_conv - t_short > 0:
            ests.append(t_conv - t_short)
    if not ests:
        return None, iters, converged
    return ({"value": float(np.median(ests)), "min": min(ests),
             "max": max(ests), "n_sweeps": len(ests)}, iters, converged)


def build_admm(nx, ny, sopts=None):
    """ADMM (CGLS graph projection) on the ROF problem of the house
    fixture."""
    from prost_tpu.backend import ADMMOptions, BackendADMM

    _, prob = build_rof(nx, ny, image="house")
    return BackendADMM(prob, ADMMOptions(residual_iter=10),
                       sopts or _solver_opts())


def _all_configs():
    """The full cell sweep.  Per cell: (metric, builder, short, long,
    sweeps).  Problems and sizes: BASELINE.md's five configs, plus the
    2048^2 and 512^2x8 sizes and the volumetric-TV operator family."""
    return [
        ("rof512_pdhg_iters_per_sec",
         lambda: build_rof(512, 512)[0], 2000, 22000, 3),
        ("tvl1_512_pdhg_iters_per_sec",
         lambda: build_rof(512, 512, lmb=1.0, dataterm="abs",
                           image="fisch")[0], 2000, 22000, 3),
        ("deblur512_pdhg_iters_per_sec",
         lambda: build_deblur(512, 512), 1000, 11000, 3),
        ("admm512_iters_per_sec", lambda: build_admm(512, 512),
         500, 5500, 3),
        ("multilabel256x8_pdhg_iters_per_sec",
         lambda: build_multilabel(256, 256, L=8), 500, 5500, 5),
        ("tight128x4_pdhg_iters_per_sec",
         lambda: build_tight(128, 128, L=4), 2000, 22000, 3),
        ("ensemble1024x128_instance_iters_per_sec",
         lambda: build_ensemble(1024, 128, 128), 100, 1100, 2),
        ("vol8x256_pdhg_iters_per_sec",
         lambda: build_vol(8, 256, 256), 500, 5500, 3),
        ("rof2048_pdhg_iters_per_sec",
         lambda: build_rof(2048, 2048)[0], 200, 2200, 4),
        ("multilabel512x8_pdhg_iters_per_sec",
         lambda: build_multilabel(512, 512, L=8, image="junction_gray"),
         200, 2200, 4),
        ("admm2048_iters_per_sec", lambda: build_admm(2048, 2048),
         100, 1100, 4),
    ]


def main(argv):
    from prost_tpu.config import use_compile_cache

    run_all = "--all" in argv
    out_path = None
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]

    device = require_gpu()
    card = card_name()
    use_compile_cache()

    def emit(rec, stdout=False):
        rec = {**rec, "device": device, "card": card}
        print(json.dumps(rec), file=None if stdout else sys.stderr,
              flush=True)
        return rec

    if not run_all:
        meas = measure_backend(build_rof(512, 512)[0])
        emit({"metric": "rof512_pdhg_iters_per_sec", **meas,
              "unit": "it/s"}, stdout=True)
        return 0

    records = []

    # Phase 1 — throughput sweep, round-robin interleaved: build + warm
    # every config (compiles happen here), then rotate (short, long)
    # timing pairs across configs so a slow spell hits all of them
    # equally.
    configs = _all_configs()
    meters = []
    for name, builder, short, long_, sweeps in configs:
        print(f"# warm {name}", file=sys.stderr, flush=True)
        meters.append(TwoPointMeter(builder(), short, long_))
    max_sweeps = max(c[4] for c in configs)
    for s in range(max_sweeps):
        for (name, _, _, _, sweeps), meter in zip(configs, meters):
            if s < sweeps:
                print(f"# sweep {s} {name}", file=sys.stderr, flush=True)
                meter.sweep()

    results = {}
    for (name, *_), meter in zip(configs, meters):
        m = meter.result()
        if name.startswith("ensemble"):
            B = 1024
            m = {**m, "value": m["value"] * B, "min": m["min"] * B,
                 "max": m["max"] * B}
        results[name] = m
        records.append(emit({"metric": name, **m, "unit": "it/s"},
                            stdout=name == "rof512_pdhg_iters_per_sec"))
    del meters  # free the states before the solve phase

    # Phase 2 — seconds-to-tolerance at the reference stopping rules:
    # iterations x measured throughput, next to a directly measured
    # run-to-convergence time
    def rec_tol(metric, iters, its_per_sec, measured=None):
        if iters is None:
            r = {"metric": metric, "value": None, "unit": "s",
                 "note": "tolerance not reached (f32 residual floor)"}
        else:
            r = {"metric": metric, "value": iters / its_per_sec,
                 "unit": "s", "iterations": iters}
            if measured is not None:
                r["measured_s"] = measured["value"]
                r["measured_min"] = measured["min"]
                r["measured_max"] = measured["max"]
                r["measured_n"] = measured["n_sweeps"]
        records.append(emit(r))

    def direct(make_backend, tol, cap, require_converged=True):
        m, its, conv = measure_seconds_to_tol_direct(make_backend, tol, cap)
        return m if (conv or not require_converged) else None

    iters_gap = measure_iters_to_gap()
    # the pd-gap rule is host-evaluated, so the direct number times
    # exactly the measured iterations-to-gap on device (tol=0 never
    # fires the backend test; the run executes the full cap)
    m = (direct(lambda so: build_rof(512, 512, sopts=so)[0], 0.0,
                iters_gap + 21, require_converged=False)
         if iters_gap else None)
    rec_tol("rof512_seconds_to_gap_1e-6_per_px", iters_gap,
            results["rof512_pdhg_iters_per_sec"]["value"], measured=m)

    for metric, make, tol, check, cap, rate_key in [
        ("tvl1_512_seconds_to_tol_1e-7",
         lambda so: build_rof(512, 512, lmb=1.0, dataterm="abs", sopts=so,
                              image="fisch")[0],
         1e-7, 2000, 200_000, "tvl1_512_pdhg_iters_per_sec"),
        ("deblur512_seconds_to_tol_1e-4",
         lambda so: build_deblur(512, 512, sopts=so),
         1e-4, 1000, 100_000, "deblur512_pdhg_iters_per_sec"),
        ("admm512_seconds_to_tol_1e-4",
         lambda so: build_admm(512, 512, sopts=so),
         1e-4, 500, 50_000, "admm512_iters_per_sec"),
        ("multilabel256x8_seconds_to_tol_1e-5",
         lambda so: build_multilabel(256, 256, L=8, sopts=so),
         1e-5, 1000, 100_000, "multilabel256x8_pdhg_iters_per_sec"),
        ("tight128x4_seconds_to_tol_2e-6",
         lambda so: build_tight(128, 128, L=4, sopts=so),
         2e-6, 2000, 200_000, "tight128x4_pdhg_iters_per_sec"),
    ]:
        it = measure_iters_to_tol(make, tol, check=check, max_iters=cap)
        m = direct(make, tol, it + 1000) if it else None
        rec_tol(metric, it, results[rate_key]["value"], measured=m)

    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"date": time.strftime("%Y-%m-%d %H:%M:%S"),
                       "device": device, "card": card,
                       "records": records}, fh, indent=1)
        print(f"# wrote {out_path}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
