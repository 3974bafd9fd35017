"""Problem: linear operator + prox lists + diagonal preconditioners.

Counterpart of /root/reference/src/problem.cu.  A Problem is a pytree
(arrays as leaves, structure static) so the whole thing can be passed
through jit; initialization (validation, gap-filling with zero proxes,
preconditioner computation) happens once, at construction.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .common import pytree_dataclass, static_field
from .config import ProstError, dtype as config_dtype
from .linop.base import DualLinearOperator, LinearOperator
from .prox.base import Prox, check_domain
from .prox.standalone import ProxZero

SCALING_IDENTITY = "identity"
SCALING_ALPHA = "alpha"
SCALING_CUSTOM = "custom"


def _fill_with_zero_prox(proxs: list[Prox], n: int, name: str) -> list[Prox]:
    """Fill uncovered index ranges with ProxZero (AddZeroProx,
    problem.cu:93-158).  Gap computation runs in the native host runtime
    (_native/src/prost_host.cpp: ph_prox_gaps)."""
    if not proxs:
        return proxs
    from ._native import host

    try:
        gaps = host.prox_gaps(
            [p.index for p in proxs], [p.size for p in proxs], n
        )
    except ValueError:
        raise ProstError(f"{name}: prox operators overlap.")
    return list(proxs) + [
        ProxZero(index=start, size=size) for start, size in gaps
    ]


@pytree_dataclass
class Problem:
    nrows: int = static_field()
    ncols: int = static_field()
    linop: LinearOperator = None
    prox_g: tuple = ()
    prox_f: tuple = ()
    prox_gstar: tuple = ()
    prox_fstar: tuple = ()
    scaling_left: jnp.ndarray = None   # Sigma diagonal, (nrows,)
    scaling_right: jnp.ndarray = None  # Tau diagonal, (ncols,)

    # ------------------------------------------------------------------
    @staticmethod
    def create(
        linop,
        prox_g=(),
        prox_f=(),
        prox_gstar=(),
        prox_fstar=(),
        nrows=None,
        ncols=None,
        scaling: str = SCALING_ALPHA,
        scaling_alpha: float = 1.0,
        scaling_left=None,
        scaling_right=None,
    ) -> "Problem":
        """Validate, fill zero proxes, compute preconditioners
        (Problem::Initialize, problem.cu:196-323)."""
        if not isinstance(linop, LinearOperator):
            linop = LinearOperator.create(linop)
        nrows = linop.nrows if nrows is None else nrows
        ncols = linop.ncols if ncols is None else ncols

        prox_g, prox_f = list(prox_g), list(prox_f)
        prox_gstar, prox_fstar = list(prox_gstar), list(prox_fstar)

        if not prox_f and not prox_fstar:
            raise ProstError("No proximal operator for f or fstar specified.")
        if not prox_g and not prox_gstar:
            raise ProstError("No proximal operator for g or gstar specified.")
        if prox_f and prox_fstar:
            raise ProstError("Prox for f AND fstar specified. Only set one!")
        if prox_g and prox_gstar:
            raise ProstError("Prox for g AND gstar specified. Only set one!")

        prox_f = _fill_with_zero_prox(prox_f, nrows, "prox_f")
        prox_g = _fill_with_zero_prox(prox_g, ncols, "prox_g")
        prox_fstar = _fill_with_zero_prox(prox_fstar, nrows, "prox_fstar")
        prox_gstar = _fill_with_zero_prox(prox_gstar, ncols, "prox_gstar")

        check_domain(prox_g, ncols, "prox_g")
        check_domain(prox_f, nrows, "prox_f")
        check_domain(prox_gstar, ncols, "prox_gstar")
        check_domain(prox_fstar, nrows, "prox_fstar")

        dt = config_dtype()
        if scaling == SCALING_ALPHA:
            # Pock-Chambolle alpha preconditioner (problem.cu:262-287):
            #   Sigma_jj = 1 / sum_k |K_jk|^alpha
            #   Tau_kk   = 1 / sum_j |K_jk|^(2-alpha)
            rs = linop.row_sum(scaling_alpha)
            cs = linop.col_sum(2.0 - scaling_alpha)
            left = jnp.where(rs > 0, 1.0 / jnp.where(rs > 0, rs, 1.0), 1.0)
            right = jnp.where(cs > 0, 1.0 / jnp.where(cs > 0, cs, 1.0), 1.0)
        elif scaling == SCALING_IDENTITY:
            left = jnp.ones(nrows, dtype=dt)
            right = jnp.ones(ncols, dtype=dt)
        elif scaling == SCALING_CUSTOM:
            # user passes the *square root* diagonals; they enter squared
            # (SetScalingCustom, problem.cu:344-364)
            left = jnp.asarray(scaling_left, dtype=dt) ** 2
            right = jnp.asarray(scaling_right, dtype=dt) ** 2
            if left.shape[0] != nrows or right.shape[0] != ncols:
                raise ProstError("Custom scaling vectors have wrong size.")
        else:
            raise ProstError(f"Unknown scaling '{scaling}'.")

        # average preconditioner entries where the prox can't handle
        # diagonal steps (AveragePreconditioners, problem.cu:503-536)
        right = _average_preconditioner(right, prox_g if prox_g else prox_gstar)
        left = _average_preconditioner(left, prox_f if prox_f else prox_fstar)

        problem = Problem(
            nrows=nrows,
            ncols=ncols,
            linop=linop,
            prox_g=tuple(prox_g),
            prox_f=tuple(prox_f),
            prox_gstar=tuple(prox_gstar),
            prox_fstar=tuple(prox_fstar),
            scaling_left=left.astype(dt),
            scaling_right=right.astype(dt),
        )
        # Host data the caller passed in (numpy coefficient arrays, Python
        # scalars) moves to the device once here, not on every jitted run.
        return jax.device_put(problem)

    # ------------------------------------------------------------------
    def dualize(self) -> "Problem":
        """Swap to the dual problem: g<->f*, f<->g*, K<->-K^T
        (Problem::Dualize, problem.cu:539-547)."""
        linop = self.linop
        dual_linop = (
            linop.child
            if isinstance(linop, DualLinearOperator)
            else DualLinearOperator(child=linop)
        )
        return Problem(
            nrows=self.ncols,
            ncols=self.nrows,
            linop=dual_linop,
            prox_g=self.prox_fstar,
            prox_f=self.prox_gstar,
            prox_gstar=self.prox_f,
            prox_fstar=self.prox_g,
            scaling_left=self.scaling_right,
            scaling_right=self.scaling_left,
        )

    # ------------------------------------------------------------------
    def normest(self, tol: float = 1e-6, max_iters: int = 100, seed: int = 0):
        """Power-iteration estimate of ||Sigma^{1/2} K Tau^{1/2}||_2
        (problem.cu:429-500)."""
        rng = np.random.RandomState(seed)
        x0 = jnp.asarray(
            rng.rand(self.ncols), dtype=self.scaling_right.dtype
        )
        return _normest_jit(self, x0, tol, max_iters)


def _average_preconditioner(precond, proxs):
    for p in proxs:
        if not p.diagsteps:
            lo, hi = p.index, p.index + p.size
            precond = precond.at[lo:hi].set(p.average_precond(precond[lo:hi]))
    return precond


@jax.jit
def _normest_jit(problem: Problem, x0, tol, max_iters):
    sqrt_l = jnp.sqrt(problem.scaling_left)
    sqrt_r = jnp.sqrt(problem.scaling_right)

    def body(carry):
        x, norm, norm_prev, i = carry
        ax = sqrt_l * problem.linop.apply(sqrt_r * x)
        norm_ax = jnp.linalg.norm(ax)
        x_new = sqrt_r * problem.linop.apply_adjoint(sqrt_l * ax)
        norm_x = jnp.linalg.norm(x_new)
        return (x_new / norm_x, norm_x / norm_ax, norm, i + 1)

    def cond(carry):
        x, norm, norm_prev, i = carry
        return (i < max_iters) & (jnp.abs(norm_prev - norm) >= tol * norm)

    init = (x0, jnp.asarray(0.0, x0.dtype), jnp.asarray(jnp.inf, x0.dtype), 0)
    _, norm, _, _ = lax.while_loop(cond, body, init)
    return norm
