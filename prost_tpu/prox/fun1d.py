"""Scalar (1D) proximal operators.

Each function computes ``prox_{tau f}(x0) = argmin_x f(x) + (1/(2 tau))(x-x0)^2``
for a family of scalar functions f parametrized by (alpha, beta).  All are
written as vectorized jnp expressions: arguments may be arrays of any shape
(broadcast against each other), which replaces the reference's
one-CUDA-thread-per-scalar model with vectorized element-wise code.

Behavioral parity with /root/reference/include/prost/prox/elemop/function_1d.hpp
(semantics re-derived, not transcribed):

  zero        f(z) = 0
  abs         f(z) = |z|                      (soft shrinkage)
  square      f(z) = z^2 / 2
  ind_leq0    f(z) = I(z <= 0)
  ind_geq0    f(z) = I(z >= 0)
  ind_eq0     f(z) = I(z == 0)
  ind_box01   f(z) = I(0 <= z <= 1)
  max_pos0    f(z) = max(0, z)
  l0          f(z) = #nonzero(z)              (hard threshold)
  huber       f(z) = z^2/(2 alpha) if |z|<=alpha else |z|-alpha/2
  lq          f(z) = |z|^alpha, alpha >= 0    (incl. nonconvex alpha<1)
  truncquad   f(z) = min(alpha z^2, beta)     (Mumford-Shah)
  trunclin    f(z) = min(alpha |z|, beta)
  lq_plus_eps f(z) = (|z|+beta)^alpha         (the reference only stubs this
                                               one — function_1d.hpp:293-306
                                               returns 0; here it is actually
                                               implemented by a Newton solve,
                                               see fun_lq_plus_eps)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def fun_zero(x0, tau, alpha, beta):
    return x0


def fun_abs(x0, tau, alpha, beta):
    # soft-thresholding
    return jnp.sign(x0) * jnp.maximum(jnp.abs(x0) - tau, 0.0)


def fun_square(x0, tau, alpha, beta):
    return x0 / (1.0 + tau)


def fun_ind_leq0(x0, tau, alpha, beta):
    return jnp.minimum(x0, 0.0)


def fun_ind_geq0(x0, tau, alpha, beta):
    return jnp.maximum(x0, 0.0)


def fun_ind_eq0(x0, tau, alpha, beta):
    return jnp.zeros_like(x0)


def fun_ind_box01(x0, tau, alpha, beta):
    return jnp.clip(x0, 0.0, 1.0)


def fun_max_pos0(x0, tau, alpha, beta):
    # prox of z -> max(0, z): shift positive part by tau, keep negatives.
    return jnp.where(x0 > tau, x0 - tau, jnp.minimum(x0, 0.0))


def fun_l0(x0, tau, alpha, beta):
    # hard thresholding: keep x0 where x0^2 > 2 tau
    return jnp.where(x0 * x0 > 2.0 * tau, x0, 0.0)


def fun_huber(x0, tau, alpha, beta):
    # prox of the Huber function with parameter alpha
    r = (x0 / tau) / (1.0 + alpha / tau)
    r = r / jnp.maximum(1.0, jnp.abs(r))
    return x0 - tau * r


def _lq_newton(t0, factor, q, num_iters: int = 30):
    """Newton iterations for min_t 0.5 (t-1)^2 + factor * t^q, t in (0, 1].

    The reference iterates until |delta| < eps (function_1d.hpp:172-191);
    here a fixed iteration count keeps the loop compile-friendly and
    fully vectorized.  30 iterations of Newton from t=1 is far past
    float64 convergence for the relevant parameter range.
    """

    def body(_, t):
        p = jnp.power(t, q)
        d1 = t - 1.0 + factor * q * p / t
        d2 = 1.0 + factor * q * (q - 1.0) * p / (t * t)
        return t - d1 / d2

    return lax.fori_loop(0, num_iters, body, t0)


def _lq_half_analytic(factor):
    """Closed form for q = 1/2 (depressed-cubic root via trigonometric
    identity; cf. function_1d.hpp:193-202)."""
    sqrt3 = jnp.sqrt(jnp.asarray(3.0, dtype=factor.dtype))
    arg = jnp.clip(factor * 3.0 * sqrt3 / 4.0, -1.0, 1.0)
    s = 2.0 * jnp.sin((jnp.arccos(arg) + jnp.pi / 2.0) / 3.0) / sqrt3
    return s * s


def fun_lq(x0, tau, alpha, beta):
    """prox of |z|^alpha for alpha >= 0 (nonconvex for alpha < 1).

    alpha enters as a *static* Python float in practice (it is a
    coefficient array broadcast, but the special cases alpha==0/1/0.5
    are resolved element-wise with jnp.where so traced values work too).
    """
    x0 = jnp.asarray(x0)
    absx = jnp.abs(x0)
    alpha = jnp.broadcast_to(jnp.asarray(alpha, dtype=x0.dtype), x0.shape)
    safe_absx = jnp.where(absx > 0, absx, 1.0)
    factor = tau * jnp.power(safe_absx, alpha - 2.0)

    # stationary point via Newton from t=1 (scaled problem on t = x/|x0|)
    t_newton = _lq_newton(jnp.ones_like(x0), factor, alpha)
    t_half = _lq_half_analytic(factor)

    # nonconvex case: check boundary condition before accepting the
    # stationary point (function_1d.hpp:236-245 logic, re-derived)
    t2 = 2.0 * (alpha - 1.0) / (alpha - 2.0)
    thresh = 0.5 * (1.0 - (t2 - 1.0) ** 2) / jnp.power(t2, alpha)
    nonconvex_keep = factor < thresh

    t_general = jnp.where(
        alpha < 1.0,
        jnp.where(
            nonconvex_keep, jnp.where(alpha == 0.5, t_half, t_newton), 0.0
        ),
        t_newton,
    )
    t_general = jnp.where(absx > 0, t_general, 0.0)
    general = t_general * absx * jnp.sign(x0)

    return jnp.where(
        alpha == 1.0,
        fun_abs(x0, tau, alpha, beta),
        jnp.where(alpha == 0.0, fun_l0(x0, tau, alpha, beta), general),
    )


def fun_truncquad(x0, tau, alpha, beta):
    # prox of min(alpha z^2, beta): compare quadratic-prox energy vs beta
    x_sq = x0 / (1.0 + 2.0 * tau * alpha)
    en_sq = alpha * x_sq * x_sq + (x_sq - x0) ** 2 / (2.0 * tau)
    return jnp.where(en_sq < beta, x_sq, x0)


def fun_trunclin(x0, tau, alpha, beta):
    # prox of min(alpha |z|, beta): compare shrinkage energy vs beta
    x_sh = jnp.sign(x0) * jnp.maximum(jnp.abs(x0) - tau * alpha, 0.0)
    en_sh = (x_sh - x0) ** 2 / (2.0 * tau) + alpha * jnp.abs(x_sh)
    return jnp.where(en_sh < beta, x_sh, x0)


def fun_lq_plus_eps(x0, tau, alpha, beta):
    """prox of (|z| + beta)^alpha, alpha >= 1, beta >= 0.

    The reference leaves this as a TODO stub returning 0
    (function_1d.hpp:293-306); here the convex case is implemented
    properly.  For z >= 0 the optimality condition is

        z - |x0| + tau * alpha * (z + beta)^(alpha - 1) = 0

    solved by Newton from z = |x0| (the objective is convex for
    alpha >= 1, so the stationary point is the minimizer whenever it is
    nonnegative; otherwise the constrained minimizer is z = 0 iff the
    derivative at 0+ is nonnegative, i.e. |x0| <= tau*alpha*beta^(alpha-1)).
    alpha < 1 falls back to the prox of the shifted |z|^alpha at beta = 0
    (= fun_lq), matching the reference's only supported surrogate.
    """
    x0 = jnp.asarray(x0)
    absx = jnp.abs(x0)
    alpha = jnp.broadcast_to(jnp.asarray(alpha, dtype=x0.dtype), x0.shape)
    beta = jnp.broadcast_to(jnp.asarray(beta, dtype=x0.dtype), x0.shape)

    def body(_, z):
        zb = jnp.maximum(z + beta, 1e-20)
        p = jnp.power(zb, alpha - 1.0)
        d1 = z - absx + tau * alpha * p
        d2 = 1.0 + tau * alpha * (alpha - 1.0) * p / zb
        return jnp.clip(z - d1 / d2, 0.0, absx)

    z = lax.fori_loop(0, 30, body, absx)
    # subgradient check at z = 0: stay at 0 if |x0| <= tau a b^(a-1)
    slope0 = tau * alpha * jnp.power(jnp.maximum(beta, 1e-20), alpha - 1.0)
    z = jnp.where(absx <= slope0, 0.0, z)
    convex = z * jnp.sign(x0)
    return jnp.where(alpha >= 1.0, convex, fun_lq(x0, tau, alpha, beta))


FUN_1D = {
    "zero": fun_zero,
    "abs": fun_abs,
    "square": fun_square,
    "ind_leq0": fun_ind_leq0,
    "ind_geq0": fun_ind_geq0,
    "ind_eq0": fun_ind_eq0,
    "ind_box01": fun_ind_box01,
    "max_pos0": fun_max_pos0,
    "l0": fun_l0,
    "huber": fun_huber,
    "lq": fun_lq,
    "lq_plus_eps": fun_lq_plus_eps,
    "truncquad": fun_truncquad,
    "trunclin": fun_trunclin,
}
