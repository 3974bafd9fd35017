"""Small instances of the structures the solver's imaging workloads use,
shared by the test modules: ROF/TV, fast and tight multilabel, deblurring
and volumetric TV.  Construction mirrors the examples (examples/)."""

import numpy as np

import prost_tpu as pt
from prost_tpu import block, function
from prost_tpu.linop import BlockGradient2D, BlockGradient3D, LinearOperator
from prost_tpu.prox import ProxElem1D, ProxElemNorm2, ProxMoreau


def zero_tol_opts(**kw):
    """SolverOptions whose convergence test never fires, so runs go to
    their iteration bound."""
    kw.setdefault("verbose", False)
    for k in ("tol_rel_primal", "tol_rel_dual",
              "tol_abs_primal", "tol_abs_dual"):
        kw.setdefault(k, 0.0)
    return pt.SolverOptions(**kw)


def rof_problem(nx, ny, f, lmb, dataterm="square"):
    """ROF (square) or TV-L1 (abs) denoising of the flat image f."""
    n = nx * ny
    grad = BlockGradient2D(row=0, col=0, nx=nx, ny=ny, L=1)
    prox_g = [ProxElem1D(index=0, size=n, fun=dataterm,
                         coeffs=(1.0, f.astype(np.float32), lmb,
                                 0.0, 0.0, 0.0, 0.0))]
    pn = ProxElemNorm2(index=0, size=2 * n, count=n, dim=2, interleaved=False,
                       fun="abs", coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return pt.Problem.create(
        LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ProxMoreau(index=0, size=2 * n, child=pn)],
    )


def ml_problem(nx, ny, L, f_lin, lmb, d_s=1.0):
    """Fast multilabel relaxation (examples/example_multilabel_fast.py)
    with linear unaries f_lin (n * L)."""
    n = nx * ny
    u = pt.Variable(n * L)
    q = pt.Variable(2 * n * L)
    s = pt.Variable(n)
    prob = pt.MinMaxProblem([u], [q, s])
    prob.add_function(u, function.sum_1d("ind_geq0", 1, 0, 1, f_lin, 0))
    prob.add_function(q, function.sum_norm2(2 * L, False, "ind_leq0",
                                            1 / lmb, 1, 1))
    prob.add_function(s, function.sum_1d("zero", 1, 0, 1, d_s, 0))
    prob.add_dual_pair(u, q, block.gradient2d(nx, ny, L))
    prob.add_dual_pair(u, s, block.sparse_kron_id(np.ones((1, L)), n))
    return prob.finalize()


def pair_local_matrix(L):
    """The tight relaxation's pairwise difference operator P, (2k, 2L)."""
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


def tight_problem(nx, ny, L=3, lmb=1.0, seed=0):
    """Tight multilabel relaxation (examples/example_multilabel_tight.py)
    on random unaries."""
    n = nx * ny
    k = L * (L - 1) // 2
    rng = np.random.RandomState(seed)
    f = rng.rand(n * L)
    P = pair_local_matrix(L)

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
    return prob.finalize()


def _blur_kernel(k=5):
    """Small motion-ish blur kernel with an asymmetric support."""
    ker = np.zeros((k, k))
    for i in range(k):
        ker[i, i] = 1.0
    ker[0, k - 1] = 0.5
    return ker / ker.sum()


def deblur_problem(nx, ny, lmb=50.0, seed=0, k=5):
    """TV deblurring (examples/example_deblurring.py): conv block + gradient
    block as a two-constraint MinProblem.  Returns (problem, f_blurred)."""
    rng = np.random.RandomState(seed)
    ny2, nx2 = ny + k - 1, nx + k - 1

    u = pt.Variable(nx * ny)
    v = pt.Variable(nx2 * ny2)
    g = pt.Variable(2 * nx * ny)
    prob = pt.MinProblem([u], [v, g])
    f_blurred = rng.rand(nx2 * ny2)
    prob.add_function(v, function.sum_1d("square", 1, f_blurred, lmb))
    prob.add_function(g, function.sum_norm2(2, False, "abs"))
    prob.add_constraint(u, v, block.conv2d(nx, ny, 1, _blur_kernel(k)))
    prob.add_constraint(u, g, block.gradient2d(nx, ny, 1))
    return prob.finalize(), f_blurred


def vol_problem(L, nx, ny, f, lmb, dataterm="square"):
    """Volumetric TV denoising of an (L, nx, ny) stack (gradient3d)."""
    n = L * nx * ny
    grad = BlockGradient3D(row=0, col=0, nx=nx, ny=ny, L=L)
    prox_g = [ProxElem1D(index=0, size=n, fun=dataterm,
                         coeffs=(1.0, f.astype(np.float32), lmb,
                                 0.0, 0.0, 0.0, 0.0))]
    pn = ProxElemNorm2(index=0, size=3 * n, count=n, dim=3,
                       interleaved=False, fun="abs",
                       coeffs=(1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0))
    return pt.Problem.create(
        LinearOperator.create([grad]), prox_g=prox_g,
        prox_fstar=[ProxMoreau(index=0, size=3 * n, child=pn)],
    )
