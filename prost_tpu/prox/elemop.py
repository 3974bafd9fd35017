"""Element-wise prox operations: 1d, norm2, ind_simplex, ind_sum.

Counterparts of ProxElemOperation<T, ELEM_OP>
(/root/reference/include/prost/prox/prox_elem_operation.{hpp,inl}): the
one-CUDA-thread-per-vector kernel becomes a single vectorized jnp expression
over a (dim, count) view of the segment; XLA fuses it with the surrounding
solver arithmetic.  Coefficients follow the reference's broadcast contract
(each of the 7 coefficients is a scalar or a per-vector array,
prox_elem_operation.hpp:105-110).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..common import pytree_dataclass, static_field
from .base import ProxSeparableSum, effective_tau
from .fun1d import FUN_1D


def scaled_fun_1d(fun, arg, tau, coeffs):
    """Apply prox of x -> c*f(a*x - b) + d*x + (e/2)*x^2 built from the prox
    of f alone, via the argument/step rescaling identities
    (elem_operation_1d.hpp:42-58):

        prox_arg = (a*(arg - d*tau))/(1 + tau*e) - b
        step     = (c*a^2*tau)/(1 + tau*e)
        result   = (f.prox(prox_arg, step) + b) / a

    Where c == 0 or a == 0 the function degenerates to the quadratic-plus-
    linear part: result = (arg - tau*d)/(1 + tau*e).
    """
    a, b, c, d, e, alpha, beta = coeffs
    degenerate = (a == 0.0) | (c == 0.0)
    safe_a = jnp.where(degenerate, 1.0, a)

    denom = 1.0 + tau * e
    lin = (arg - tau * d) / denom

    prox_arg = (safe_a * (arg - d * tau)) / denom - b
    step = (c * safe_a * safe_a * tau) / denom
    full = (fun(prox_arg, step, alpha, beta) + b) / safe_a

    return jnp.where(degenerate, lin, full)


@pytree_dataclass
class ProxElem1D(ProxSeparableSum):
    """Separable sum of scalar proxes with the 7-coefficient parametrization
    (elem_operation:1d:<fun>; matlab/+prost/+function/sum_1d.m)."""

    index: int = static_field()
    size: int = static_field()
    fun: str = static_field()
    coeffs: tuple = ()

    # dim=1, count=size, layout irrelevant
    @property
    def count(self):
        return self.size

    @property
    def dim(self):
        return 1

    @property
    def interleaved(self):
        return False

    @property
    def diagsteps(self) -> bool:
        return True

    def average_precond(self, seg):
        return seg  # diagsteps=True: never called, identity for safety

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        tau = effective_tau(tau_diag, tau_scal, invert_tau)
        return scaled_fun_1d(FUN_1D[self.fun], arg, tau, self.coeffs)


@pytree_dataclass
class ProxElemNorm2(ProxSeparableSum):
    """Sum of h(||x_i||_2) over dim-dimensional vectors, h parametrized by
    the 7 coefficients (elem_operation:norm2:<fun>,
    elem_operation_norm2.hpp:39-88; matlab sum_norm2.m)."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    interleaved: bool = static_field()
    fun: str = static_field()
    coeffs: tuple = ()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        norm_sq = jnp.sum(vecs * vecs, axis=0)
        norm = jnp.sqrt(norm_sq)
        safe_norm = jnp.where(norm > 0, norm, 1.0)

        prox_norm = scaled_fun_1d(FUN_1D[self.fun], norm, tau, self.coeffs)
        scale = jnp.where(norm > 0, prox_norm / safe_norm, 0.0)
        return self.from_vectors(vecs * scale[None, :])


@pytree_dataclass
class ProxElemIndSimplex(ProxSeparableSum):
    """Projection onto the unit simplex per dim-vector
    (elem_operation:ind_simplex, elem_operation_ind_simplex.hpp:50-115;
    algorithm of Chen & Ye, arXiv:1101.6081).

    The reference shell-sorts each vector in per-thread local memory with a
    MAX_DIM=1024 cap; here it is one batched descending sort along the dim
    axis with no size cap.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    interleaved: bool = static_field()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        d = self.dim
        # sort descending along component axis
        u = -jnp.sort(-vecs, axis=0)
        css = (jnp.cumsum(u, axis=0) - 1.0) / jnp.arange(
            1, d + 1, dtype=vecs.dtype
        )[:, None]
        # rho = largest k (1-based) with u_k > css_k ; tmax = css_rho
        mask = u > css
        rho = jnp.maximum(jnp.sum(mask, axis=0) - 1, 0)  # 0-based index
        tmax = jnp.take_along_axis(css, rho[None, :], axis=0)[0]
        return self.from_vectors(jnp.maximum(vecs - tmax[None, :], 0.0))


@pytree_dataclass
class ProxElemIndSum(ProxSeparableSum):
    """Projection onto the affine set {sum_i x_i = 1} per dim-vector
    (elem_operation:ind_sum, elem_operation_ind_sum.hpp:46-58)."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    interleaved: bool = static_field()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)
        shift = (jnp.sum(vecs, axis=0) - 1.0) / self.dim
        return self.from_vectors(vecs - shift[None, :])
