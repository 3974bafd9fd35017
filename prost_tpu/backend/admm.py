"""Graph-projection ADMM backend.

Re-design of /root/reference/src/backend/backend_admm.cu: the ~15
zip-iterator kernels per iteration become one jitted iteration function
(XLA fuses the elementwise work into the K / K^T applies); the CGLS inner
solve is a nested ``lax.while_loop`` (see cgls.py).

The algorithm solves the graph-form problem (problem.hpp:39-47)

    min_{x,z} g(x) + f(z)   s.t.  z = K x

by ADMM on the scaled variables x~ = Tau^{-1/2} x, z~ = Sigma^{1/2} z with
K~ = Sigma^{1/2} K Tau^{1/2}.  Per iteration (backend_admm.cu:355-665),
with all of x_half/x_proj/x_dual, z_half/z_proj/z_dual kept in *unscaled*
space exactly like the reference:

    t1 = Tau^{-1/2} (alpha x_half + (1-alpha) x_proj + x_dual)
    t2 = Sigma^{1/2} (z_half + z_dual)
    u  = argmin ||K~ u - (t2 - K~ t1)||^2 + ||u||^2    (CGLS, warm-started)
    x_proj = Tau^{1/2} (u + t1);   z_proj = K x_proj
    x_dual = Tau^{1/2} t1 - x_proj
    z_dual = Sigma^{-1/2} t2 - z_proj
    x_half = prox_g(x_proj - x_dual; tau_diag=Tau,  tau_scal=1/rho)
    z_half = prox_f(z_proj - z_dual; tau_diag=Sigma, tau_scal=rho, invert)

Residuals (every residual_iter iterations, backend_admm.cu:535-630):

    primal_res = ||Sigma^{1/2} (K x_half - z_half)||
    primal_var = ||Sigma^{1/2} z_half||
    w = -rho Tau^{-1}  (x_half - x_proj + x_dual)
    y = -rho Sigma     (z_half - z_proj + z_dual)
    dual_var   = ||Tau^{1/2} w||
    dual_res   = ||Tau^{1/2} (w + K^T y)||

rho-adaptation a la Boyd with delta growth and a rho_prev/rho rescale of
both dual variables (backend_admm.cu:632-663).  CG tolerance schedule
tightens as cg_tol_min / (iter+1)^cg_tol_pow, floored at cg_tol_max
(backend_admm.cu:408-410).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..common import pytree_dataclass
from ..config import ProstError
from ..problem import Problem
from ..prox.base import apply_proxs
from ..prox.combinators import ProxMoreau
from .cgls import cgls_solve


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Mirror of BackendADMM<T>::Options (backend_admm.hpp:38-63) with the
    MATLAB defaults (matlab/+prost/+backend/admm.m:4-13)."""

    rho0: float = 1.0
    residual_iter: int = 1
    arb_delta: float = 1.05
    arb_tau: float = 0.8
    arb_gamma: float = 1.01
    alpha: float = 1.7
    cg_max_iter: int = 10
    cg_tol_pow: float = 1.3
    cg_tol_min: float = 1e-5
    cg_tol_max: float = 1e-8
    # "cgls" = the reference's warm-started approximate projection;
    # "dct"  = EXACT graph projection for lone-gradient2d problems with
    # constant preconditioner: (I + c^2 G^T G) u = rhs is a screened
    # Neumann-Laplacian solve, diagonalized by DCT-II (no reference
    # analog — a direct O(n log n) alternative to the CG loop);
    # "cheby" = fixed-coefficient Chebyshev iteration on the same system
    # (spectrum [1, 1 + 8 c^2]): zero dot products, same per-step
    # contraction rate as CGLS on this well-conditioned system;
    # "auto" = cgls.
    projection: str = "auto"
    cheby_degree: int = 10


@pytree_dataclass
class ADMMState:
    x_half: jnp.ndarray = None
    x_proj: jnp.ndarray = None
    x_dual: jnp.ndarray = None
    z_half: jnp.ndarray = None
    z_proj: jnp.ndarray = None
    z_dual: jnp.ndarray = None
    cg_warm: jnp.ndarray = None  # previous CGLS solution (scaled space)
    rho: jnp.ndarray = None
    delta: jnp.ndarray = None
    arb_l: jnp.ndarray = None
    arb_u: jnp.ndarray = None
    iteration: jnp.ndarray = None
    primal_residual: jnp.ndarray = None
    dual_residual: jnp.ndarray = None
    primal_var_norm: jnp.ndarray = None
    dual_var_norm: jnp.ndarray = None
    converged: jnp.ndarray = None


class BackendADMM:
    """Host-side driver; all math lives in the jitted functions below."""

    def __init__(self, problem: Problem, opts: ADMMOptions, solver_opts):
        self.problem = problem
        self.opts = opts
        self.solver_opts = solver_opts

        # synthesize missing proxes via Moreau (backend_admm.cu:313-344)
        if problem.prox_g:
            self.prox_g = problem.prox_g
        elif problem.prox_gstar:
            self.prox_g = tuple(
                ProxMoreau(index=p.index, size=p.size, child=p)
                for p in problem.prox_gstar
            )
        else:
            raise ProstError("Neither prox_g nor prox_gstar specified.")

        if problem.prox_f:
            self.prox_f = problem.prox_f
        elif problem.prox_fstar:
            self.prox_f = tuple(
                ProxMoreau(index=p.index, size=p.size, child=p)
                for p in problem.prox_fstar
            )
        else:
            raise ProstError("Neither prox_f nor prox_fstar specified.")

        if opts.projection in ("dct", "cheby"):
            self.proj_plan = dct_projection_plan(problem)
            if self.proj_plan is None:
                raise ProstError(
                    f"ADMMOptions(projection='{opts.projection}') requires "
                    "a lone gradient2d operator with constant "
                    "preconditioner."
                )
        elif opts.projection in ("cgls", "auto"):
            self.proj_plan = None
        else:
            raise ProstError(f"Unknown projection '{opts.projection}'.")

    # ------------------------------------------------------------------
    def initial_state(self) -> ADMMState:
        p = self.problem
        dt = p.scaling_left.dtype

        x0 = self.solver_opts.x0
        x_half = (
            jnp.zeros(p.ncols, dt) if x0 is None else jnp.asarray(x0, dt)
        )
        if x_half.shape[0] != p.ncols:
            raise ProstError("Initial primal solution has wrong size.")
        z_half = (
            jnp.zeros(p.nrows, dt) if x0 is None else p.linop.apply(x_half)
        )

        def zeros(n):
            return jnp.zeros(n, dt)

        def scalar(v=0.0):
            return jnp.asarray(v, dt)

        return ADMMState(
            x_half=x_half, x_proj=zeros(p.ncols), x_dual=zeros(p.ncols),
            z_half=z_half, z_proj=zeros(p.nrows), z_dual=zeros(p.nrows),
            cg_warm=zeros(p.ncols),
            rho=scalar(self.opts.rho0), delta=scalar(self.opts.arb_delta),
            arb_l=scalar(), arb_u=scalar(),
            iteration=jnp.asarray(0, jnp.int32),
            primal_residual=scalar(), dual_residual=scalar(),
            primal_var_norm=scalar(), dual_var_norm=scalar(),
            converged=jnp.asarray(False),
        )

    # ------------------------------------------------------------------
    def run(self, state: ADMMState, until_iter: int) -> ADMMState:
        sopts = self.solver_opts
        return _admm_run(
            self.problem,
            self.prox_g,
            self.prox_f,
            self.opts,
            self.proj_plan,
            (sopts.tol_rel_primal, sopts.tol_rel_dual,
             sopts.tol_abs_primal, sopts.tol_abs_dual),
            state,
            jnp.asarray(until_iter, jnp.int32),
        )

    # ------------------------------------------------------------------
    def current_solution(self, state: ADMMState):
        """(x, z, y, w): primal halves plus duals recovered as
        -rho Sigma^{+1}/Tau^{-1} (half - proj + dual)
        (backend_admm.cu:699-745)."""
        p = self.problem
        s = state
        w = -s.rho / p.scaling_right * (s.x_half - s.x_proj + s.x_dual)
        y = -s.rho * p.scaling_left * (s.z_half - s.z_proj + s.z_dual)
        return s.x_half, s.z_half, y, w


def dct_projection_plan(problem):
    """Exact graph-projection plan for a lone BlockGradient2D with constant
    diagonal preconditioner: returns the static tuple (L, nx, ny, c2) with
    c2 = Sigma*Tau — K~^T K~ = c2 * G^T G is a scaled Neumann Laplacian,
    diagonalized by DCT-II — or None when the structure does not apply.
    Must run on a CONCRETE problem (reads the preconditioner values), i.e.
    at backend-construction time, not under jit."""
    import numpy as np

    from ..linop.gradient import BlockGradient2D

    blocks = getattr(problem.linop, "blocks", ())
    if len(blocks) != 1 or not isinstance(blocks[0], BlockGradient2D):
        return None
    b = blocks[0]
    if b.label_first:
        return None
    sl = np.asarray(problem.scaling_left)
    sr = np.asarray(problem.scaling_right)
    if not (np.allclose(sl, sl[0]) and np.allclose(sr, sr[0])):
        return None
    c2 = float(sl[0]) * float(sr[0])
    return b.L, b.nx, b.ny, c2


def _dct_denom(plan, dtype):
    """denom[i, j] = 1 + c2*(lam_x[i] + lam_y[j]), the DCT-II eigenvalues
    of I + K~^T K~.  ``plan`` is static, so this folds to a constant."""
    import numpy as np

    _, nx, ny, c2 = plan
    lam_x = 4.0 * np.sin(np.pi * np.arange(nx) / (2 * nx)) ** 2
    lam_y = 4.0 * np.sin(np.pi * np.arange(ny) / (2 * ny)) ** 2
    return jnp.asarray(1.0 + c2 * (lam_x[:, None] + lam_y[None, :]), dtype)


def _dct_project(plan, rhs):
    """Solve (I + K~^T K~) u = rhs exactly in DCT space."""
    from jax.scipy.fft import dctn, idctn

    L, nx, ny, _ = plan
    U = rhs.reshape(L, nx, ny)
    spec = dctn(U, type=2, norm="ortho", axes=(1, 2))
    return idctn(spec / _dct_denom(plan, rhs.dtype)[None], type=2,
                 norm="ortho", axes=(1, 2)).reshape(-1)


def _cheby_project_generic(plan, k_tilde, k_tilde_adj, d, u0, degree: int):
    """Solve min ||K~ u - d||^2 + ||u||^2 by ``degree`` steps of the
    classical Chebyshev iteration on (I + K~^T K~) u = K~^T d, warm-started
    from u0.  ``plan`` = (L, nx, ny, c2) is static: the spectrum bound
    1 + 8*c2 (Neumann-Laplacian eigenvalues in [0, 8) scaled by
    c2 = Sigma*Tau) folds into compile-time coefficients, so the solve has
    NO reductions."""
    _, _, _, c2 = plan
    hi = 1.0 + 8.0 * c2
    theta = (hi + 1.0) / 2.0
    delta = (hi - 1.0) / 2.0
    sigma1 = theta / delta

    def M(u):
        return u + k_tilde_adj(k_tilde(u))

    b = k_tilde_adj(d)
    r = b - M(u0)
    x = u0
    dv = r * (1.0 / theta)
    rho_prev = 1.0 / sigma1
    for _ in range(int(degree) - 1):
        x = x + dv
        r = r - M(dv)
        rho_k = 1.0 / (2.0 * sigma1 - rho_prev)
        dv = rho_k * rho_prev * dv + (2.0 * rho_k / delta) * r
        rho_prev = rho_k
    return x + dv


def admm_residual_adapt(problem, opts: ADMMOptions, tols, q: ADMMState,
                        primal_res, primal_norm, dual_res, dual_norm):
    """Store residual norms, test convergence, and run the Boyd
    rho-adaptation with its dual-variable rescale (backend_admm.cu:632-663).
    """
    tol_rel_p, tol_rel_d, tol_abs_p, tol_abs_d = tols
    eps_pri = jnp.sqrt(float(problem.nrows)) * tol_abs_p + tol_rel_p * primal_norm
    eps_dua = jnp.sqrt(float(problem.ncols)) * tol_abs_d + tol_rel_d * dual_norm

    it = q.iteration.astype(q.rho.dtype)
    c1 = (dual_res < eps_dua) & (opts.arb_tau * it > q.arb_l)
    c2 = (primal_res < eps_pri) & (opts.arb_tau * it > q.arb_u) & ~c1
    rho_new = jnp.where(
        c1, q.rho * q.delta, jnp.where(c2, q.rho / q.delta, q.rho)
    )
    delta_new = jnp.where(c1 | c2, q.delta * opts.arb_gamma, q.delta)
    arb_u = jnp.where(c1, it, q.arb_u)
    arb_l = jnp.where(c2, it, q.arb_l)

    # rescale dual variables on rho change (backend_admm.cu:650-663)
    fac = q.rho / rho_new
    return dataclasses.replace(
        q,
        x_dual=q.x_dual * fac, z_dual=q.z_dual * fac,
        rho=rho_new, delta=delta_new, arb_l=arb_l, arb_u=arb_u,
        primal_residual=primal_res, primal_var_norm=primal_norm,
        dual_residual=dual_res, dual_var_norm=dual_norm,
        converged=(primal_res < eps_pri) & (dual_res < eps_dua),
    )


def admm_step(problem, prox_g, prox_f, opts: ADMMOptions, tols, s: ADMMState,
              proj_plan=None):
    """One graph-projection ADMM iteration as a pure function."""
    Sigma = problem.scaling_left
    Tau = problem.scaling_right
    sqrt_S = jnp.sqrt(Sigma)
    sqrt_T = jnp.sqrt(Tau)
    K = problem.linop

    def k_tilde(u):
        return sqrt_S * K.apply(sqrt_T * u)

    def k_tilde_adj(v):
        return sqrt_T * K.apply_adjoint(sqrt_S * v)

    # relaxed arguments (backend_admm.cu:357-389)
    t1 = (opts.alpha * s.x_half + (1.0 - opts.alpha) * s.x_proj + s.x_dual) / sqrt_T
    t2 = sqrt_S * (s.z_half + s.z_dual)

    # graph projection: min ||K~ u - d||^2 + ||u||^2
    d = t2 - k_tilde(t1)
    if opts.projection == "dct":
        # exact solve of the normal equations in DCT space; the static
        # plan was validated at backend construction (BackendADMM.__init__)
        u = _dct_project(proj_plan, k_tilde_adj(d))
    elif opts.projection == "cheby":
        u = _cheby_project_generic(proj_plan, k_tilde, k_tilde_adj, d,
                                   s.cg_warm, opts.cheby_degree)
    else:
        # the reference's warm-started CGLS with its tolerance schedule
        it_f = (s.iteration + 1).astype(t1.dtype)
        cg_tol = jnp.maximum(
            opts.cg_tol_min / jnp.power(it_f, opts.cg_tol_pow),
            opts.cg_tol_max,
        )
        u, _ = cgls_solve(
            k_tilde, k_tilde_adj, d, s.cg_warm, 1.0, cg_tol,
            opts.cg_max_iter,
        )

    x_proj = sqrt_T * (u + t1)
    z_proj = K.apply(x_proj)
    x_dual = sqrt_T * t1 - x_proj
    z_dual = t2 / sqrt_S - z_proj

    # prox steps: g with step Tau/rho, f with inverted step 1/(rho Sigma)
    x_half = apply_proxs(prox_g, x_proj - x_dual, Tau, 1.0 / s.rho, False)
    z_half = apply_proxs(prox_f, z_proj - z_dual, Sigma, s.rho, True)

    s = dataclasses.replace(
        s,
        x_half=x_half, x_proj=x_proj, x_dual=x_dual,
        z_half=z_half, z_proj=z_proj, z_dual=z_dual,
        cg_warm=u, iteration=s.iteration + 1,
    )

    def compute_residuals(q: ADMMState) -> ADMMState:
        primal_res = jnp.linalg.norm(sqrt_S * (K.apply(q.x_half) - q.z_half))
        primal_norm = jnp.linalg.norm(sqrt_S * q.z_half)
        w = -q.rho / Tau * (q.x_half - q.x_proj + q.x_dual)
        y = -q.rho * Sigma * (q.z_half - q.z_proj + q.z_dual)
        dual_norm = jnp.linalg.norm(sqrt_T * w)
        dual_res = jnp.linalg.norm(sqrt_T * (w + K.apply_adjoint(y)))
        return admm_residual_adapt(
            problem, opts, tols, q,
            primal_res, primal_norm, dual_res, dual_norm,
        )

    ri = max(int(opts.residual_iter), 1)
    do_res = (s.iteration % ri == 0)
    return lax.cond(do_res, compute_residuals, lambda q: q, s)


@partial(jax.jit, static_argnums=(3, 4), donate_argnums=(6,))
def _admm_run(problem, prox_g, prox_f, opts: ADMMOptions, proj_plan, tols,
              state, until):
    def body(s: ADMMState) -> ADMMState:
        return admm_step(problem, prox_g, prox_f, opts, tols, s,
                         proj_plan=proj_plan)

    def cond(s: ADMMState):
        return (s.iteration < until) & ~s.converged

    return lax.while_loop(cond, body, state)
