"""Conjugate-gradient least squares: min ||A x - b||^2 + shift ||x||^2.

Re-design of the vendored CGLS solver the reference uses for
ADMM's graph projection (/root/reference/include/prost/cgls.hpp:223-380):
the cuBLAS axpy/nrm2 call sequence becomes one jittable ``lax.while_loop``
whose body is two operator applies plus fused vector arithmetic; under a
device mesh the dot products reduce with psum automatically (they are
jnp reductions over sharded arrays).

``apply_a`` / ``apply_at`` are arbitrary closures (the ADMM backend passes
the preconditioned operator Sigma^{1/2} K Tau^{1/2}).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def cgls_solve(apply_a, apply_at, b, x0, shift, tol, maxit: int):
    """Returns (x, iterations).  Mirrors cgls::Solve semantics: warm start
    from x0, stop when ||s|| <= tol * ||s0|| or ||x|| * tol >= 1, or at
    maxit."""
    dt = b.dtype
    eps = jnp.finfo(dt).eps
    # below ~10 eps the normal-equations residual is roundoff noise and CG
    # recurrences drift; clamp so an unreachable tol can't push past that
    tol = jnp.maximum(tol, 10.0 * eps)

    r = b - apply_a(x0)
    s = apply_at(r) - shift * x0
    p = s
    gamma0 = jnp.sum(s * s)
    norms0 = jnp.sqrt(gamma0)

    def body(carry):
        x, r, p, gamma, k, done = carry
        q = apply_a(p)
        delta = jnp.sum(q * q) + shift * jnp.sum(p * p)
        delta = jnp.where(delta <= 0, eps, delta)
        alpha = gamma / delta
        x = x + alpha * p
        r = r - alpha * q
        s = apply_at(r) - shift * x
        gamma_new = jnp.sum(s * s)
        beta = gamma_new / jnp.where(gamma > 0, gamma, 1.0)
        p = s + beta * p
        normx = jnp.linalg.norm(x)
        converged = (jnp.sqrt(gamma_new) <= norms0 * tol) | (normx * tol >= 1.0)
        return (x, r, p, gamma_new, k + 1, converged)

    def cond(carry):
        _, _, _, gamma, k, done = carry
        return (k < maxit) & ~done

    init = (x0, r, p, gamma0, jnp.asarray(0, jnp.int32), norms0 < eps)
    x, _, _, _, k, _ = lax.while_loop(cond, body, init)
    return x, k
