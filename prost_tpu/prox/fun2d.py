"""2D prox functions operating on pairs (e.g. the two singular values of an
N x 2 matrix).

Counterpart of
/root/reference/include/prost/prox/elemop/function_2d.hpp: each is a pure
vectorized function (y1, y2, tau, alpha, beta) -> (x1, x2).
"""

from __future__ import annotations

import jax.numpy as jnp

from .fun1d import FUN_1D


def _make_sum_1d(fun1d):
    def fun(y1, y2, tau, alpha, beta):
        return fun1d(y1, tau, alpha, beta), fun1d(y2, tau, alpha, beta)

    return fun


def fun2d_ind_l1_ball(y1, y2, tau, alpha, beta):
    """Projection of (y1, y2) onto the l1-ball of radius alpha
    (function_2d.hpp:42-83): project (|y1|, |y2|) onto the simplex of size
    alpha, restore signs; pass-through when already inside."""
    v1, v2 = jnp.abs(y1), jnp.abs(y2)
    inside = v1 + v2 <= alpha

    mu1 = jnp.maximum(v1, v2)
    mu2 = jnp.minimum(v1, v2)
    l = 0.5 * (mu2 - mu1 + alpha)
    rho = jnp.where(l <= 0.0, 1.0, 2.0)
    theta = (mu1 + jnp.where(rho == 2.0, mu2, 0.0) - alpha) / rho

    p1 = jnp.maximum(v1 - theta, 0.0)
    p2 = jnp.maximum(v2 - theta, 0.0)
    x1 = jnp.where(inside, y1, jnp.sign(y1) * p1)
    x2 = jnp.where(inside, y2, jnp.sign(y2) * p2)
    return x1, x2


def _make_moreau(fun2d):
    def fun(y1, y2, tau, alpha, beta):
        r1, r2 = fun2d(y1 / tau, y2 / tau, 1.0 / tau, alpha, beta)
        return y1 - tau * r1, y2 - tau * r2

    return fun


FUN_2D = {f"sum_1d:{name}": _make_sum_1d(f) for name, f in FUN_1D.items()}
FUN_2D["ind_l1_ball"] = fun2d_ind_l1_ball
FUN_2D["moreau:ind_l1_ball"] = _make_moreau(fun2d_ind_l1_ball)
