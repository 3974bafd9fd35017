"""Exact DCT graph projection for ADMM (ADMMOptions(projection='dct')).

The projection step solves (I + K~^T K~) u = K~^T d; for a lone gradient2d
operator with constant preconditioner, K~^T K~ is a scaled Neumann
Laplacian, diagonalized by DCT-II.  No reference analog (the reference
always runs approximate CGLS, backend_admm.cu:424-441).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import prost_tpu as pt
from prost_tpu.backend import BackendADMM, ADMMOptions
from prost_tpu.backend.admm import _dct_project, dct_projection_plan
from prost_tpu.backend.cgls import cgls_solve
from prost_tpu.config import ProstError
from problems import rof_problem, zero_tol_opts


def test_dct_projection_matches_converged_cgls():
    nx, ny = 24, 16
    f = np.random.RandomState(0).rand(nx * ny).astype(np.float32)
    prob = rof_problem(nx, ny, f, 8.0)
    plan = dct_projection_plan(prob)
    assert plan is not None

    sqrt_S = jnp.sqrt(prob.scaling_left)
    sqrt_T = jnp.sqrt(prob.scaling_right)

    def kt(u):
        return sqrt_S * prob.linop.apply(sqrt_T * u)

    def kt_adj(v):
        return sqrt_T * prob.linop.apply_adjoint(sqrt_S * v)

    d = jnp.asarray(np.random.RandomState(1).randn(prob.nrows),
                    jnp.float32)
    u_dct = _dct_project(plan, kt_adj(d))
    u_cg, _ = cgls_solve(kt, kt_adj, d, jnp.zeros(prob.ncols, jnp.float32),
                         1.0, 1e-12, 400)
    np.testing.assert_allclose(np.asarray(u_dct), np.asarray(u_cg),
                               atol=2e-5)
    # direct check of the normal equations: (I + K~^T K~) u == rhs
    rhs = kt_adj(d)
    lhs = u_dct + kt_adj(kt(u_dct))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=2e-5)


def test_dct_admm_converges_to_same_energy():
    nx = ny = 24
    rng = np.random.RandomState(2)
    f = rng.rand(nx * ny).astype(np.float32)
    lmb = 8.0
    prob = rof_problem(nx, ny, f, lmb)
    sopts = pt.SolverOptions(max_iters=4000, verbose=False,
                             tol_rel_primal=1e-5, tol_rel_dual=1e-5,
                             tol_abs_primal=1e-5, tol_abs_dual=1e-5)

    def energy(x):
        x = np.asarray(x)
        kx = np.asarray(prob.linop.apply(jnp.asarray(x)))
        g = kx.reshape(2, -1)
        return (lmb / 2 * np.sum((x - f) ** 2)
                + np.sum(np.sqrt(g[0] ** 2 + g[1] ** 2)))

    results = {}
    for proj in ("cgls", "dct"):
        b = BackendADMM(prob, ADMMOptions(rho0=8.0, residual_iter=10,
                                          projection=proj), sopts)
        solver = pt.Solver(prob, lambda p, o, bb=b: bb, sopts)
        res = solver.solve()
        assert res.result == pt.ConvergenceResult.CONVERGED
        results[proj] = (energy(res.x), res.iterations)

    e_cg, it_cg = results["cgls"]
    e_dct, it_dct = results["dct"]
    np.testing.assert_allclose(e_dct, e_cg, rtol=1e-3)
    # the exact projection should not need more iterations than CGLS
    assert it_dct <= it_cg * 1.2


def test_dct_rejected_for_unsupported_structure():
    # two blocks -> no plan -> ProstError at the first run
    from prost_tpu import block, function

    n = 12 * 12
    u = pt.Variable(n)
    q = pt.Variable(2 * n)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("square", 1, 0.5, 4.0))
    prob.add_function(q, function.sum_norm2(2, False, "ind_leq0", 1, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, 1, 0))
    prob.add_dual_pair(u, q, block.gradient2d(12, 12, 1))
    prob.add_dual_pair(u, s, block.identity())
    core = prob.finalize()
    assert dct_projection_plan(core) is None
    with pytest.raises(ProstError):
        BackendADMM(core, ADMMOptions(projection="dct"), zero_tol_opts())


def test_generic_cheby_matches_cgls_solution():
    """projection='cheby' (fixed-coefficient, dot-product-free) and the
    reference CGLS are different inexact solvers of the SAME kappa<=2 SPD
    system; at degree 10 both sit at the f32 floor, so the ADMM
    trajectories agree to f32 arithmetic."""
    nx, ny = 32, 24
    rng = np.random.RandomState(11)
    f = rng.rand(nx * ny).astype(np.float32)
    prob = rof_problem(nx, ny, f, 8.0)
    g1 = BackendADMM(prob, ADMMOptions(residual_iter=10), zero_tol_opts())
    s1 = g1.run(g1.initial_state(), 60)
    g2 = BackendADMM(prob, ADMMOptions(residual_iter=10,
                                       projection="cheby"), zero_tol_opts())
    s2 = g2.run(g2.initial_state(), 60)
    np.testing.assert_allclose(np.asarray(s1.x_half), np.asarray(s2.x_half),
                               atol=2e-5)
    np.testing.assert_allclose(float(s1.rho), float(s2.rho), rtol=1e-6)
