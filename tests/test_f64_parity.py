"""f64 end-to-end parity suite.

The reference MEX layer builds with real = double
(matlab/+prost/private/config.hpp:6-7) and its examples stop at
1e-6..1e-7 tolerances in that mode.  This suite pins one x64 end-to-end
solve per family to the reference's TIGHTEST stopping rules, and bounds
the float32 path's drift against the x64 trajectory for every structure
(the drift vs a double-precision run is the honest accuracy statement
for float32)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import prost_tpu as pt
from prost_tpu import block, function
from prost_tpu.backend.pdhg import BackendPDHG, PDHGOptions

from problems import deblur_problem, ml_problem, tight_problem, vol_problem


class _x64:
    """Enable x64 + f64 default dtype for the with-block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)
        pt.set_dtype(jnp.float64)

    def __exit__(self, *a):
        pt.set_dtype(jnp.float32)
        jax.config.update("jax_enable_x64", False)


def _tols(t):
    return pt.SolverOptions(verbose=False, tol_rel_primal=t,
                            tol_rel_dual=t, tol_abs_primal=t,
                            tol_abs_dual=t)


def _rof_problem(nx, ny, lmb, dataterm="square", seed=0):
    n = nx * ny
    rng = np.random.RandomState(seed)
    f = rng.rand(n)
    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    prob = pt.MinMaxProblem([u], [q])
    prob.add_function(u, function.sum_1d(dataterm, 1, f, lmb))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, 1))
    return prob, u


def test_f64_tvl1_to_tol_1e7():
    """TV-L1 in x64 at the reference's tol 1e-7 (example_tvl1.m:47-53) —
    unreachable in f32 (residual floor), the canonical double-mode
    workload."""
    with _x64():
        prob, u = _rof_problem(16, 16, lmb=1.2, dataterm="abs")
        opts = pt.options(max_iters=200_000, verbose=False,
                          tol_rel_primal=1e-7, tol_rel_dual=1e-7,
                          tol_abs_primal=1e-7, tol_abs_dual=1e-7)
        res = pt.solve(prob, pt.backend_pdhg(stepsize="boyd",
                                             residual_iter=10), opts)
        assert res.result.value == "converged"
        assert np.asarray(u.val).dtype == np.float64
        assert np.all(np.isfinite(u.val))


def test_f64_tight_multilabel_to_tol_2e6():
    """Tight multilabel relaxation in x64 at the reference's tol 2e-6
    (example_multilabel_tight.m:97-102), generic path."""
    with _x64():
        core = tight_problem(10, 10, L=3, lmb=1.0, seed=1)
        opts = PDHGOptions(stepsize="boyd", residual_iter=10)
        backend = BackendPDHG(core, opts, _tols(2e-6))
        state = backend.initial_state()
        state = backend.run(state, 200_000)
        assert bool(np.asarray(state.converged))
        assert np.asarray(state.x).dtype == np.float64


def test_f64_admm_rof_to_tol_1e6():
    """ADMM ROF in x64 at tol 1e-6 through the reference CGLS projection
    algebra (backend_admm.cu:408-441), generic path."""
    from prost_tpu.backend.admm import ADMMOptions, BackendADMM

    with _x64():
        prob, u = _rof_problem(16, 16, lmb=16.0)
        core = prob.finalize()
        backend = BackendADMM(core, ADMMOptions(residual_iter=10),
                              _tols(1e-6))
        state = backend.initial_state()
        state = backend.run(state, 50_000)
        assert bool(np.asarray(state.converged))
        assert np.asarray(state.x_half).dtype == np.float64


def test_f64_multilabel_fast_to_tol_1e5():
    """Fast multilabel relaxation in x64 at the reference's tol 1e-5
    (example_multilabel_fast.m:55-60), generic path."""
    with _x64():
        nx = ny = 12
        L = 3
        n = nx * ny
        rng = np.random.RandomState(5)
        core = ml_problem(nx, ny, L, rng.rand(n * L), 0.7)
        backend = BackendPDHG(
            core, PDHGOptions(stepsize="boyd", residual_iter=10),
            _tols(1e-5))
        state = backend.run(backend.initial_state(), 100_000)
        assert bool(np.asarray(state.converged))
        assert np.asarray(state.x).dtype == np.float64


# ---------------------------------------------------------------------------
# float32 vs float64 drift bounds, one per structure
# ---------------------------------------------------------------------------

_N_IT = 51  # aligned for residual_iter=5 runs (51 % 5 == 1)


def _drift_problem(structure):
    """A builder for the structure's small test instance; called once in
    float32 and once under x64, it builds the same problem data."""
    if structure in ("rof", "tvl1", "admm"):
        lmb = 1.2 if structure == "tvl1" else (16.0 if structure == "admm"
                                                else 8.0)
        dataterm = "abs" if structure == "tvl1" else "square"
        return lambda: _rof_problem(16, 16, lmb, dataterm,
                                    seed=3)[0].finalize()
    if structure == "multilabel":
        f = np.random.RandomState(7).rand(12 * 12 * 3).astype(np.float32)
        return lambda: ml_problem(12, 12, 3, np.asarray(f, np.float64), 0.7)
    if structure == "tight":
        return lambda: tight_problem(10, 10, L=3, lmb=1.0, seed=2)
    if structure == "deblur":
        return lambda: deblur_problem(12, 12, lmb=30.0, seed=4)[0]
    f = np.random.RandomState(9).rand(3 * 12 * 12).astype(np.float32)
    return lambda: vol_problem(3, 12, 12, np.asarray(f, np.float64), 6.0)


def _run(structure, build):
    from prost_tpu.backend.admm import ADMMOptions, BackendADMM

    if structure == "admm":
        b = BackendADMM(build(), ADMMOptions(residual_iter=5), _tols(0))
        return np.asarray(b.run(b.initial_state(), 26).x_half, np.float64)
    opts = PDHGOptions(stepsize="boyd", residual_iter=5,
                       scale_steps_operator=False)
    b = BackendPDHG(build(), opts, _tols(0))
    return np.asarray(b.run(b.initial_state(), _N_IT).x, np.float64)


@pytest.mark.parametrize("structure,bound", [
    ("rof", 2e-5), ("tvl1", 2e-5), ("multilabel", 2e-5), ("tight", 2e-5),
    ("vol", 2e-5), ("deblur", 5e-5), ("admm", 5e-4)])
def test_f32_drift_vs_f64(structure, bound):
    """The float32 iterate stays within f32 round-off accumulation of the
    x64 trajectory of the same program."""
    build = _drift_problem(structure)
    x32 = _run(structure, build)
    with _x64():
        x64 = _run(structure, build)
    assert float(np.max(np.abs(x32 - x64))) < bound
