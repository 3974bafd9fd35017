"""Plain reference for the ROF configuration, independent of prost.

    min_u  lmb/2 ||u - f||^2 + sum_px ||(grad u)_px||_2

on an (H, W) image, forward differences with a Neumann boundary (the last
difference along each axis is zero).  Solved through its dual

    max_{||p_px|| <= 1}  D(p) = <f, K^T p> - ||K^T p||^2 / (2 lmb),
    u(p) = f - K^T p / lmb

by FISTA with gradient restart (Beck & Teboulle 2009, O'Donoghue & Candes
2015), a different algorithm family from the solver under test.  Every
chunk of iterations checks the primal-dual gap P(u(p)) - D(p), which bounds
P(u) - P* for any u, so the best dual value seen is a certified lower
bound on the optimum.  Works on a leading batch axis: arrays are
(..., H, W) and every reduction is per instance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def grad(u):
    """(..., H, W) -> (..., 2, H, W): forward differences, Neumann."""
    gx = jnp.zeros_like(u).at[..., :-1, :].set(u[..., 1:, :] - u[..., :-1, :])
    gy = jnp.zeros_like(u).at[..., :, :-1].set(u[..., :, 1:] - u[..., :, :-1])
    return jnp.stack([gx, gy], axis=-3)


def grad_adjoint(p):
    """K^T p for p of shape (..., 2, H, W) (minus the divergence)."""
    px, py = p[..., 0, :, :], p[..., 1, :, :]
    dx = jnp.zeros_like(px)
    dx = dx.at[..., 1:, :].add(px[..., :-1, :]).at[..., :-1, :].add(
        -px[..., :-1, :])
    dy = jnp.zeros_like(py)
    dy = dy.at[..., :, 1:].add(py[..., :, :-1]).at[..., :, :-1].add(
        -py[..., :, :-1])
    return dx + dy


def _sum2(a):
    return jnp.sum(a, axis=(-2, -1))


def tv(u):
    g = grad(u)
    return _sum2(jnp.sqrt(jnp.sum(g * g, axis=-3)))


def primal(u, f, lmb):
    return lmb / 2 * _sum2((u - f) ** 2) + tv(u)


def dual(p, f, lmb):
    d = grad_adjoint(p)
    return _sum2(f * d) - _sum2(d * d) / (2 * lmb)


def _project(p):
    nrm = jnp.sqrt(jnp.sum(p * p, axis=-3, keepdims=True))
    return p / jnp.maximum(nrm, 1)


@partial(jax.jit, static_argnums=(3,))
def _fista(carry, f, lmb, iters):
    step = lmb / 8  # 1 / L, L = ||K||^2 / lmb <= 8 / lmb

    def body(_, c):
        p, r, t = c
        g = grad(grad_adjoint(r) - lmb * f) / lmb
        p_new = _project(r - step * g)
        t_new = (1 + jnp.sqrt(1 + 4 * t * t)) / 2
        # restart where the momentum points uphill
        up = jnp.sum((r - p_new) * (p_new - p), axis=(-3, -2, -1)) > 0
        t_new = jnp.where(up, jnp.ones_like(t_new), t_new)
        mom = jnp.where(up, 0, (t - 1) / t_new)[..., None, None, None]
        return p_new, p_new + mom * (p_new - p), t_new

    return lax.fori_loop(0, iters, body, carry)


@jax.jit
def _gap(p, f, lmb):
    u = f - grad_adjoint(p) / lmb
    return primal(u, f, lmb), dual(p, f, lmb), u


def solve(f, lmb, dtype=jnp.float64, rel_gap=1e-8, chunk=500,
          max_iters=40000):
    """Reference solve of the (..., H, W) observation ``f``.

    Returns dict with ``u`` (float64 numpy), ``lower`` (certified lower
    bound on the optimum, per instance), ``rel_gap`` and ``iters``.  With
    ``dtype`` below float64 the iteration runs in that precision for
    ``max_iters`` iterations (the control) and the bound is not
    certified."""
    fd = jnp.asarray(f, dtype)
    lm = jnp.asarray(lmb, dtype)
    batch = fd.shape[:-2]
    p = jnp.zeros(batch + (2,) + fd.shape[-2:], dtype)
    carry = (p, p, jnp.ones(batch, dtype))
    best = np.full(batch, -np.inf)
    it = 0
    gap = np.inf
    while it < max_iters:
        carry = _fista(carry, fd, lm, chunk)
        it += chunk
        if dtype != jnp.float64 and it < max_iters:
            continue
        pe, de, u = _gap(carry[0], fd, lm)
        pe, de = np.asarray(pe, np.float64), np.asarray(de, np.float64)
        best = np.maximum(best, de)
        gap = float(np.max((pe - best) / np.abs(best)))
        if gap <= rel_gap:
            break
    return {"u": np.asarray(u, np.float64), "lower": best, "rel_gap": gap,
            "iters": it}


def compare(x, f, lmb, ref):
    """The numbers that decide ``correct`` for answers ``x`` (..., H, W):
    the worst relative excess of the answer's float64 energy over the
    reference's certified lower bound."""
    pe = np.asarray(primal(jnp.asarray(x, jnp.float64),
                           jnp.asarray(f, jnp.float64), lmb))
    excess = (pe - ref["lower"]) / np.abs(ref["lower"])
    return {"excess": float(np.max(excess))}


def reference(images, cfg, dtype=jnp.float64, **kw):
    """``solve`` for the (..., H, W) observations of a request."""
    return solve(images, cfg["lmb"], dtype, **kw)


def numbers(answers, images, cfg, ref):
    return compare(answers, images, cfg["lmb"], ref)
