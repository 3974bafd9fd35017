"""Plain reference for the fast multilabel configuration, independent of
prost.

    min_{u_px in simplex}  <u, c> + lmb sum_px ||(grad u)_px||_2

u is (L, H, W), one simplex per pixel over the L labels; the norm is taken
jointly over the 2L gradient components of a pixel (forward differences,
Neumann boundary).  The simplex is projected onto exactly (prost enforces
the sum-to-one constraint through a Lagrange multiplier instead).  Its dual

    max_{||q_px|| <= lmb}  D(q) = sum_px min_l (c + K^T q)_{l,px}

gives a certified lower bound on the optimum for any feasible q.  Solved
by primal-dual iterations with fixed steps (tau sigma ||K||^2 < 1) in
plain jax.numpy.  Works on a leading batch axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from reference.rof import grad, grad_adjoint


def unaries(gray, labels):
    """Quadratic unaries of an (..., H, W) grey image against ``labels``
    evenly spaced grey levels: (..., L, H, W)."""
    means = np.linspace(0.0, 1.0, labels)
    g = np.asarray(gray, np.float64)[..., None, :, :]
    return (g - means.reshape((labels, 1, 1))) ** 2


def project_simplex(v):
    """Euclidean projection of every pixel's label vector (axis -3) onto
    the unit simplex, by sorting (Held et al. 1974)."""
    L = v.shape[-3]
    s = -jnp.sort(-v, axis=-3)
    css = jnp.cumsum(s, axis=-3) - 1
    k = jnp.arange(1, L + 1, dtype=v.dtype).reshape((L, 1, 1))
    active = s - css / k > 0
    rho = jnp.sum(active, axis=-3, keepdims=True)  # active set is a prefix
    theta = jnp.take_along_axis(css, rho - 1, axis=-3) / rho.astype(v.dtype)
    return jnp.maximum(v - theta, 0)


def _sum3(a):
    return jnp.sum(a, axis=(-3, -2, -1))


def _norm_px(g):
    """Per-pixel norm of (..., L, 2, H, W) over the label and direction
    axes."""
    return jnp.sqrt(jnp.sum(g * g, axis=(-4, -3)))


def primal(u, c, lmb):
    return _sum3(u * c) + lmb * jnp.sum(_norm_px(grad(u)), axis=(-2, -1))


def dual(q, c):
    return jnp.sum(jnp.min(c + grad_adjoint(q), axis=-3), axis=(-2, -1))


def _project_ball(q, lmb):
    nrm = _norm_px(q)[..., None, None, :, :]
    return q * jnp.minimum(1, lmb / jnp.maximum(nrm, lmb * 1e-30))


@partial(jax.jit, static_argnums=(3,))
def _pdhg(carry, c, lmb, iters):
    tau, sigma = 0.25, 0.495  # tau sigma ||K||^2 <= 0.99, ||K||^2 <= 8

    def body(_, cr):
        u, q = cr
        u_new = project_simplex(u - tau * (grad_adjoint(q) + c))
        q = _project_ball(q + sigma * grad(2 * u_new - u), lmb)
        return u_new, q

    return lax.fori_loop(0, iters, body, carry)


@jax.jit
def _gap(u, q, c, lmb):
    return primal(u, c, lmb), dual(q, c)


def solve(c, lmb, dtype=jnp.float64, rel_gap=1e-6, chunk=500,
          max_iters=60000):
    """Reference solve for unaries ``c`` (..., L, H, W).  Returns dict
    with ``u``, ``lower`` (certified lower bound per instance),
    ``rel_gap`` and ``iters``; below float64 it runs ``max_iters``
    iterations in ``dtype`` (the control) and certifies nothing."""
    cd = jnp.asarray(c, dtype)
    lm = jnp.asarray(lmb, dtype)
    u = jnp.full(cd.shape, 1.0 / cd.shape[-3], dtype)
    q = jnp.zeros(cd.shape[:-2] + (2,) + cd.shape[-2:], dtype)
    batch = cd.shape[:-3]
    best = np.full(batch, -np.inf)
    carry = (u, q)
    it = 0
    gap = np.inf
    while it < max_iters:
        carry = _pdhg(carry, cd, lm, chunk)
        it += chunk
        if dtype != jnp.float64 and it < max_iters:
            continue
        pe, de = (np.asarray(v, np.float64) for v in _gap(*carry, cd, lm))
        best = np.maximum(best, de)
        gap = float(np.max((pe - best) / np.abs(best)))
        if gap <= rel_gap:
            break
    return {"u": np.asarray(carry[0], np.float64), "lower": best,
            "rel_gap": gap, "iters": it}


def compare(u, c, lmb, ref):
    """The numbers that decide ``correct`` for answers ``u`` (..., L, H,
    W): the worst relative excess of the float64 energy of the answer,
    projected onto the simplex, over the certified lower bound; and the
    worst violation of the sum-to-one constraint that the projection
    hides."""
    u64 = jnp.asarray(u, jnp.float64)
    pe = np.asarray(primal(project_simplex(u64), jnp.asarray(c, jnp.float64),
                           lmb))
    excess = (pe - ref["lower"]) / np.abs(ref["lower"])
    infeas = np.max(np.abs(np.asarray(jnp.sum(u64, axis=-3)) - 1.0))
    return {"excess": float(np.max(excess)), "sum_gap": float(infeas)}


def reference(images, cfg, dtype=jnp.float64, **kw):
    """``solve`` for the (..., H, W) grey observations of a request."""
    return solve(unaries(images, cfg["labels"]), cfg["lmb"], dtype, **kw)


def numbers(answers, images, cfg, ref):
    return compare(answers, unaries(images, cfg["labels"]), cfg["lmb"], ref)
