"""Primal-dual hybrid gradient (PDHG / Chambolle-Pock) backend.

Re-design of /root/reference/src/backend/backend_pdhg.cu: the
per-iteration sequence of ~8 fused CUDA kernels becomes a single jitted
``lax.while_loop`` body — XLA fuses the prox-argument arithmetic, the prox
itself, and the residual transforms into the K / K^T applications, and the
whole chunk of iterations runs on-device with no host round-trips.

Iteration (on the preconditioned problem; Sigma = scaling_left diag,
Tau = scaling_right diag):

    x^{k+1} = prox_g^{tau Tau}  (x^k - tau Tau K^T y^k)
    xb      = (1+theta) x^{k+1} - theta x^k        (folded into K xb below)
    y^{k+1} = prox_f*^{sigma Sigma}(y^k + sigma Sigma K xb)

Residuals (preconditioned, computed every ``residual_iter`` iterations,
formulas re-derived from backend_pdhg.cu:73-120):

    z_hat = (y^k - y^{k+1})/(sigma sqrt(Sigma)) + sqrt(Sigma)((1+theta)Kx^{k+1} - theta Kx^k)
    primal_residual = || z_hat - sqrt(Sigma) Kx^{k+1} ||,  primal_var_norm = ||z_hat||
    w_hat = (x^k - x^{k+1})/(tau sqrt(Tau)) - sqrt(Tau) K^T y^k
    dual_residual = || w_hat + sqrt(Tau) K^T y^{k+1} ||,   dual_var_norm = ||w_hat||

One deliberate deviation (default mode): the reference computes the dual
residual *before* refreshing K^T y (backend_pdhg.cu:372-380), so its
w-side quantities lag an iteration; here K^T y^{k+1} is computed first and
the residual uses mathematically consistent iterates.  Warm starts
likewise initialize kx = K x0 and kty = K^T y0 (the reference leaves them
zero for one iteration, backend_pdhg.cu:288-308).

``PDHGOptions.reference_residuals = True`` reproduces the reference's
EXACT sequence instead, for A/B trajectory validation: the dual residual
uses the stale K^T y^{k-1} / K^T y^k pair (backend_pdhg.cu:420-431 feeds
kty_prev_/kty_ before the swap at :377-380), and the previous iterates
rotate EVERY iteration (the swaps at :331/:344/:366/:377) rather than
only at residual iterations — so goldstein/boyd adaptation decisions,
and hence whole trajectories, match the reference step for step.

Step-size schemes (backend_pdhg.hpp:41-54):
  alg1       constant tau/sigma, theta = 1
  alg2       accelerated: theta = 1/sqrt(1+2 gamma tau); tau *= theta; sigma /= theta
  goldstein  residual-balancing (backend_pdhg.cu:443-460)
  boyd       residual-converging (backend_pdhg.cu:462-476)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..common import pytree_dataclass, static_field
from ..config import ProstError
from ..problem import Problem
from ..prox.base import apply_proxs
from ..prox.combinators import ProxMoreau


@dataclasses.dataclass(frozen=True)
class PDHGOptions:
    """Mirror of BackendPDHG<T>::Options (backend_pdhg.hpp:57-82) with the
    MATLAB defaults (matlab/+prost/+backend/pdhg.m:4-14)."""

    tau0: float = 1.0
    sigma0: float = 1.0
    residual_iter: int = 1
    scale_steps_operator: bool = True
    alg2_gamma: float = 0.0
    arg_alpha0: float = 0.5
    arg_nu: float = 0.95
    arg_delta: float = 1.5
    arb_delta: float = 1.05
    arb_tau: float = 0.8
    stepsize: str = "boyd"  # alg1 | alg2 | goldstein | boyd
    # reproduce the reference's exact residual sequence (stale-kty dual
    # residual + every-iteration prev rotation) — see module docstring
    reference_residuals: bool = False


@pytree_dataclass
class PDHGState:
    x: jnp.ndarray = None
    y: jnp.ndarray = None
    kx: jnp.ndarray = None
    kty: jnp.ndarray = None
    x_prev: jnp.ndarray = None
    y_prev: jnp.ndarray = None
    kx_prev: jnp.ndarray = None
    kty_prev: jnp.ndarray = None
    tau: jnp.ndarray = None
    sigma: jnp.ndarray = None
    theta: jnp.ndarray = None
    arg_alpha: jnp.ndarray = None  # goldstein state
    arb_l: jnp.ndarray = None      # boyd state
    arb_u: jnp.ndarray = None
    iteration: jnp.ndarray = None
    primal_residual: jnp.ndarray = None
    dual_residual: jnp.ndarray = None
    primal_var_norm: jnp.ndarray = None
    dual_var_norm: jnp.ndarray = None
    converged: jnp.ndarray = None


class BackendPDHG:
    """Host-side driver object holding static config; all math is in the
    jitted free functions below."""

    def __init__(self, problem: Problem, opts: PDHGOptions, solver_opts):
        self.problem = problem
        self.opts = opts
        self.solver_opts = solver_opts

        # synthesize missing proxes via Moreau (backend_pdhg.cu:236-266)
        if problem.prox_g:
            self.prox_g = problem.prox_g
        elif problem.prox_gstar:
            self.prox_g = tuple(
                ProxMoreau(index=p.index, size=p.size, child=p)
                for p in problem.prox_gstar
            )
        else:
            raise ProstError("Neither prox_g nor prox_gstar specified.")

        if problem.prox_fstar:
            self.prox_fstar = problem.prox_fstar
        elif problem.prox_f:
            self.prox_fstar = tuple(
                ProxMoreau(index=p.index, size=p.size, child=p)
                for p in problem.prox_f
            )
        else:
            raise ProstError("Neither prox_f nor prox_fstar specified.")

    # ------------------------------------------------------------------
    def initial_state(self) -> PDHGState:
        p = self.problem
        dt = p.scaling_left.dtype
        tau, sigma = self.opts.tau0, self.opts.sigma0

        if self.opts.scale_steps_operator:
            norm = float(p.normest())
            if abs(norm - 1.0) > 0.1:
                tau /= norm
                sigma /= norm
                if self.solver_opts.verbose:
                    print(
                        f"|K|={norm:.6g} => Rescaled tau={tau:.6g}, "
                        f"sigma={sigma:.6g}."
                    )

        x0 = self.solver_opts.x0
        y0 = self.solver_opts.y0
        x = jnp.zeros(p.ncols, dt) if x0 is None else jnp.asarray(x0, dt)
        y = jnp.zeros(p.nrows, dt) if y0 is None else jnp.asarray(y0, dt)
        if x.shape[0] != p.ncols:
            raise ProstError("Initial primal solution has wrong size.")
        if y.shape[0] != p.nrows:
            raise ProstError("Initial dual solution has wrong size.")

        kx = p.linop.apply(x) if x0 is not None else jnp.zeros(p.nrows, dt)
        kty = p.linop.apply_adjoint(y) if y0 is not None else jnp.zeros(p.ncols, dt)

        # distinct buffers throughout: the jitted run donates the state, and
        # donation rejects aliased buffers (f(donate(a), donate(a)))
        def scalar():
            return jnp.zeros((), dt)

        return PDHGState(
            x=x, y=y, kx=kx, kty=kty,
            x_prev=x.copy(), y_prev=y.copy(),
            kx_prev=kx.copy(), kty_prev=kty.copy(),
            tau=jnp.asarray(tau, dt), sigma=jnp.asarray(sigma, dt),
            theta=jnp.asarray(1.0, dt),
            arg_alpha=jnp.asarray(self.opts.arg_alpha0, dt),
            arb_l=scalar(), arb_u=scalar(),
            iteration=jnp.asarray(0, jnp.int32),
            primal_residual=scalar(), dual_residual=scalar(),
            primal_var_norm=scalar(), dual_var_norm=scalar(),
            converged=jnp.asarray(False),
        )

    # ------------------------------------------------------------------
    def run(self, state: PDHGState, until_iter: int) -> PDHGState:
        """Run jitted iterations until ``until_iter`` (exclusive) or
        convergence, whichever comes first."""
        sopts = self.solver_opts
        return _pdhg_run(
            self.problem,
            self.prox_g,
            self.prox_fstar,
            self.opts,
            (sopts.tol_rel_primal, sopts.tol_rel_dual,
             sopts.tol_abs_primal, sopts.tol_abs_dual),
            state,
            jnp.asarray(until_iter, jnp.int32),
        )

    # ------------------------------------------------------------------
    def current_solution(self, state: PDHGState):
        """(x, z, y, w) with z, w reconstructed from finite differences of
        the iterates (backend_pdhg.cu:513-563).

        With residual_iter > 1 the *_prev iterates date from the most
        recent residual iteration (they are only persisted there — see
        pdhg_step); exact parity with the reference at residual_iter=1,
        and the difference vanishes at convergence (z -> Kx, w -> -K^T y).
        """
        p = self.problem
        w = (state.x_prev - state.x) / (p.scaling_right * state.tau) - state.kty_prev
        z = (state.y_prev - state.y) / (state.sigma * p.scaling_left) + (
            1.0 + state.theta
        ) * state.kx - state.theta * state.kx_prev
        return state.x, z, state.y, w


def _eps_primal(problem, tols, primal_var_norm):
    tol_rel_primal, _, tol_abs_primal, _ = tols
    return (
        jnp.sqrt(float(problem.nrows)) * tol_abs_primal
        + tol_rel_primal * primal_var_norm
    )


def _eps_dual(problem, tols, dual_var_norm):
    _, tol_rel_dual, _, tol_abs_dual = tols
    return (
        jnp.sqrt(float(problem.ncols)) * tol_abs_dual
        + tol_rel_dual * dual_var_norm
    )


def residual_and_adapt(problem, opts: PDHGOptions, tols, s: PDHGState,
                       primal_res, primal_norm, dual_res, dual_norm, it):
    """Store residual norms, test convergence, and run the residual-based
    step-size adaptation (goldstein backend_pdhg.cu:443-460 / boyd
    backend_pdhg.cu:462-476).  ``it`` is the pre-increment iteration counter
    of the residual iteration."""
    s = dataclasses.replace(
        s,
        primal_residual=primal_res,
        primal_var_norm=primal_norm,
        dual_residual=dual_res,
        dual_var_norm=dual_norm,
    )

    eps_pri = _eps_primal(problem, tols, primal_norm)
    eps_dua = _eps_dual(problem, tols, dual_norm)
    s = dataclasses.replace(
        s, converged=(primal_res < eps_pri) & (dual_res < eps_dua)
    )

    if opts.stepsize == "goldstein":
        scale = eps_dua / eps_pri
        up = s.dual_residual > scale * s.primal_residual * opts.arg_delta
        dn = s.dual_residual < scale * s.primal_residual / opts.arg_delta
        fac = 1.0 - s.arg_alpha
        tau = jnp.where(up, s.tau / fac, jnp.where(dn, s.tau * fac, s.tau))
        sigma = jnp.where(
            up, s.sigma * fac, jnp.where(dn, s.sigma / fac, s.sigma)
        )
        arg_alpha = jnp.where(up | dn, s.arg_alpha * opts.arg_nu, s.arg_alpha)
        s = dataclasses.replace(s, tau=tau, sigma=sigma, arg_alpha=arg_alpha)
    elif opts.stepsize == "boyd":
        it = it.astype(s.tau.dtype)
        c1 = (s.dual_residual < eps_dua) & (opts.arb_tau * it > s.arb_l)
        c2 = (
            (s.primal_residual < eps_pri)
            & (opts.arb_tau * it > s.arb_u)
            & ~c1
        )
        tau = jnp.where(
            c1, s.tau / opts.arb_delta,
            jnp.where(c2, s.tau * opts.arb_delta, s.tau),
        )
        sigma = jnp.where(
            c1, s.sigma * opts.arb_delta,
            jnp.where(c2, s.sigma / opts.arb_delta, s.sigma),
        )
        arb_u = jnp.where(c1, it, s.arb_u)
        arb_l = jnp.where(c2, it, s.arb_l)
        s = dataclasses.replace(
            s, tau=tau, sigma=sigma, arb_l=arb_l, arb_u=arb_u
        )
    return s


def pdhg_step(problem, prox_g, prox_fstar, opts: PDHGOptions, tols, state):
    """One PDHG iteration as a pure function on the state pytree.

    This is the jit-free building block: ``_pdhg_run`` wraps it in a
    ``lax.while_loop``; the multi-chip/batched paths vmap/shard it directly.
    """
    Sigma = problem.scaling_left
    Tau = problem.scaling_right
    sqrt_S = jnp.sqrt(Sigma)
    sqrt_T = jnp.sqrt(Tau)

    def compute_residuals(s: PDHGState) -> PDHGState:
        z_hat = (s.y_prev - s.y) / (s.sigma * sqrt_S) + sqrt_S * (
            (1.0 + s.theta) * s.kx - s.theta * s.kx_prev
        )
        p_diff = z_hat - sqrt_S * s.kx
        w_hat = (s.x_prev - s.x) / (s.tau * sqrt_T) - sqrt_T * s.kty_prev
        d_diff = w_hat + sqrt_T * s.kty

        return residual_and_adapt(
            problem, opts, tols, s,
            jnp.linalg.norm(p_diff), jnp.linalg.norm(z_hat),
            jnp.linalg.norm(d_diff), jnp.linalg.norm(w_hat),
            s.iteration,
        )

    def body(s: PDHGState) -> PDHGState:
        # primal step
        arg = s.x - s.tau * Tau * s.kty
        x_new = apply_proxs(prox_g, arg, Tau, s.tau, False)
        kx_new = problem.linop.apply(x_new)

        # dual step (extrapolated Kx folded into the prox argument)
        arg_y = s.y + s.sigma * Sigma * (
            (1.0 + s.theta) * kx_new - s.theta * s.kx
        )
        y_new = apply_proxs(prox_fstar, arg_y, Sigma, s.sigma, False)
        kty_new = problem.linop.apply_adjoint(y_new)

        new = dataclasses.replace(
            s, x=x_new, y=y_new, kx=kx_new, kty=kty_new,
        )

        ri = max(int(opts.residual_iter), 1)
        do_res = (s.iteration % ri == 0)

        if opts.reference_residuals:
            # reference-exact sequence: prevs rotate EVERY iteration
            # (backend_pdhg.cu:331/:344/:366/:377) and the dual residual
            # uses the stale pair (K^T y^{k-1}, K^T y^k) because the
            # reference computes residuals before refreshing kty
            # (:372-380).  s.kty_prev is K^T y^{k-1} thanks to the
            # rotation; s.kty is K^T y^k.
            new = dataclasses.replace(
                new, x_prev=s.x, y_prev=s.y, kx_prev=s.kx, kty_prev=s.kty,
            )

            def ref_residuals(q: PDHGState) -> PDHGState:
                z_hat = (q.y_prev - q.y) / (q.sigma * sqrt_S) + sqrt_S * (
                    (1.0 + q.theta) * q.kx - q.theta * q.kx_prev
                )
                p_diff = z_hat - sqrt_S * q.kx
                w_hat = (q.x_prev - q.x) / (q.tau * sqrt_T) \
                    - sqrt_T * s.kty_prev
                d_diff = w_hat + sqrt_T * s.kty
                return residual_and_adapt(
                    problem, opts, tols, q,
                    jnp.linalg.norm(p_diff), jnp.linalg.norm(z_hat),
                    jnp.linalg.norm(d_diff), jnp.linalg.norm(w_hat),
                    q.iteration,
                )

            new = lax.cond(do_res, ref_residuals, lambda q: q, new)
        else:
            # Default mode: residuals + step adaptation every
            # residual_iter iterations from CONSISTENT iterates.  The
            # previous iterates feed ONLY the residual formulas, so they
            # are persisted into the state only inside this branch: on
            # the other (residual_iter - 1)/residual_iter iterations the
            # *_prev buffers pass through the loop carry untouched (free
            # in XLA's donated while-loop buffers), halving the
            # per-iteration HBM writes vs. the reference's always-rotate
            # scheme (backend_pdhg.cu:374 swaps every iteration).
            def with_prevs(q: PDHGState) -> PDHGState:
                q = dataclasses.replace(
                    q, x_prev=s.x, y_prev=s.y, kx_prev=s.kx, kty_prev=s.kty,
                )
                return compute_residuals(q)

            new = lax.cond(do_res, with_prevs, lambda q: q, new)

        # alg2 acceleration runs every iteration (backend_pdhg.cu:483-488)
        if opts.stepsize == "alg2":
            theta = 1.0 / jnp.sqrt(1.0 + 2.0 * opts.alg2_gamma * new.tau)
            new = dataclasses.replace(
                new, theta=theta, tau=theta * new.tau, sigma=new.sigma / theta
            )

        return dataclasses.replace(new, iteration=new.iteration + 1)

    return body(state)


@partial(jax.jit, static_argnums=(3,), donate_argnums=(5,))
def _pdhg_run(problem, prox_g, prox_fstar, opts: PDHGOptions, tols, state, until):
    def body(s: PDHGState) -> PDHGState:
        return pdhg_step(problem, prox_g, prox_fstar, opts, tols, s)

    def cond(s: PDHGState):
        return (s.iteration < until) & ~s.converged

    return lax.while_loop(cond, body, state)
