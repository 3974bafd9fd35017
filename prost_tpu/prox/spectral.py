"""Spectral prox operators: functions of eigenvalues / singular values of
small matrices stored per-vector in the flat variable.

Counterparts of the reference's elem_operation_eigen_{2x2,3x3,
nxn}.hpp, elem_operation_singular_nx2.hpp and elem_operation_mass_norm.hpp.
The reference decomposes each tiny matrix inside one CUDA thread with
hand-written Householder/QL/Cardano routines; here every decomposition is a
*batched* closed form (2x2) or a batched ``jnp.linalg.eigh`` over the
(count, n, n) stack, which XLA vectorizes.

The skew-symmetric (mass-norm) decomposition is re-derived rather than
translated: for skew M, M Mᵀ = -M² is symmetric PSD with doubly-degenerate
eigenvalues σ²; picking a unit eigenvector u per plane and v = M u / σ gives
M = Σ σ_k (v_k u_kᵀ - u_k v_kᵀ), on which the shrink (mass prox) or clamp
(comass-ball projection) acts — replacing the reference's skewReduce/Givens/
2x2-SVD pipeline (elem_operation_mass_norm.hpp:14-90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..common import einsum, pytree_dataclass, static_field
from .base import ProxSeparableSum, effective_tau
from .elemop import scaled_fun_1d
from .fun1d import FUN_1D
from .fun2d import FUN_2D


def scaled_fun_2d(fun, y1, y2, tau, coeffs):
    """2D analog of scaled_fun_1d: prox of c*f(a*(s1,s2) - b) + d*s + e/2 s^2
    applied through a 2D base function (elem_operation_singular_nx2.hpp:71-96)."""
    a, b, c, d, e, alpha, beta = coeffs
    degenerate = (a == 0.0) | (c == 0.0)
    safe_a = jnp.where(degenerate, 1.0, a)

    denom = 1.0 + tau * e
    lin1 = (y1 - tau * d) / denom
    lin2 = (y2 - tau * d) / denom

    p1 = (safe_a * (y1 - d * tau)) / denom - b
    p2 = (safe_a * (y2 - d * tau)) / denom - b
    step = (c * safe_a * safe_a * tau) / denom
    x1, x2 = fun(p1, p2, step, alpha, beta)
    x1 = (x1 + b) / safe_a
    x2 = (x2 + b) / safe_a

    return (
        jnp.where(degenerate, lin1, x1),
        jnp.where(degenerate, lin2, x2),
    )


def _eig_sym_2x2(a11, a12, a22):
    """Closed-form eigendecomposition of symmetric 2x2 matrices
    ([[a11, a12], [a12, a22]]), batched.  Returns (rt1, rt2, cs, sn) with
    rt1 >= rt2 and first eigenvector (cs, sn) (cf. helper dsyev2,
    elem_operation_eigen_2x2.hpp:29-96; re-derived from the standard
    closed form)."""
    tr = a11 + a22
    df = a11 - a22
    rad = jnp.sqrt(df * df + 4.0 * a12 * a12)
    rt1 = 0.5 * (tr + rad)
    rt2 = 0.5 * (tr - rad)

    # eigenvector for rt1: (a12, rt1 - a11) or (rt1 - a22, a12)
    v1 = rt1 - a22
    v2 = a12
    nrm = jnp.sqrt(v1 * v1 + v2 * v2)
    safe = nrm > 0
    cs = jnp.where(safe, v1 / jnp.where(safe, nrm, 1.0), 1.0)
    sn = jnp.where(safe, v2 / jnp.where(safe, nrm, 1.0), 0.0)
    return rt1, rt2, cs, sn


@pytree_dataclass
class ProxElemEigen2x2(ProxSeparableSum):
    """Spectral prox of symmetric 2x2 matrices (dim=4, stored row-major per
    vector; input is symmetrized (arg + arg^T)/2 as in
    elem_operation_eigen_2x2.hpp:111)."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    interleaved: bool = static_field()
    fun: str = static_field()
    coeffs: tuple = ()

    @property
    def dim(self):
        return 4

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (4, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        a11, a12 = vecs[0], (vecs[1] + vecs[2]) / 2.0
        a22 = vecs[3]
        rt1, rt2, cs, sn = _eig_sym_2x2(a11, a12, a22)

        f = FUN_1D[self.fun]
        s1 = scaled_fun_1d(f, rt1, tau, self.coeffs)
        s2 = scaled_fun_1d(f, rt2, tau, self.coeffs)

        t11 = s1 * cs * cs + s2 * sn * sn
        t12 = s1 * cs * sn - s2 * sn * cs
        t22 = s1 * sn * sn + s2 * cs * cs
        return self.from_vectors(jnp.stack([t11, t12, t12, t22]))


def _spectral_prox_nxn(mats, taus, fun, coeffs):
    """Batched spectral prox: eigh each (n, n) symmetric matrix, prox the
    eigenvalues, reconstruct.  mats: (count, n, n); taus: (count,)."""
    sym = (mats + jnp.swapaxes(mats, -1, -2)) / 2.0
    evals, evecs = jnp.linalg.eigh(sym)  # (count, n), (count, n, n)
    s = scaled_fun_1d(fun, evals, taus[:, None], coeffs)
    return einsum("cij,cj,ckj->cik", evecs, s, evecs)


@pytree_dataclass
class ProxElemEigenNxN(ProxSeparableSum):
    """Spectral prox of symmetric n x n matrices (dim = n*n, row-major per
    vector).  Covers the reference's eigen_3x3 (Cardano/Kopp,
    elem_operation_eigen_3x3.hpp) and eigen_nxn (Householder+QL, n <= 32,
    elem_operation_eigen_nxn.hpp) as one batched eigh; no n cap."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    n: int = static_field()
    interleaved: bool = static_field()
    fun: str = static_field()
    coeffs: tuple = ()

    @property
    def dim(self):
        return self.n * self.n

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (n*n, count)
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)
        tau = jnp.broadcast_to(tau, (self.count,))
        mats = vecs.T.reshape(self.count, self.n, self.n)
        out = _spectral_prox_nxn(mats, tau, FUN_1D[self.fun], self.coeffs)
        return self.from_vectors(out.reshape(self.count, self.dim).T)


@pytree_dataclass
class ProxElemSingularNx2(ProxSeparableSum):
    """Prox acting on the two singular values of an N x 2 matrix per vector
    (elem_operation_singular_nx2.hpp): layout is the two columns
    concatenated (planar), dim = 2*N.  The 2D base function receives
    (smax, smin)."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    interleaved: bool = static_field()
    fun: str = static_field()  # key into FUN_2D
    coeffs: tuple = ()

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (2n, count)
        n = self.dim // 2
        tau = effective_tau(self.vector_tau(tau_diag), tau_scal, invert_tau)

        a, b = vecs[:n], vecs[n:]
        d11 = jnp.sum(a * a, axis=0)
        d12 = jnp.sum(a * b, axis=0)
        d22 = jnp.sum(b * b, axis=0)

        trace = d11 + d22
        det = d11 * d22 - d12 * d12
        disc = jnp.sqrt(jnp.maximum(0.0, 0.25 * trace * trace - det))
        lmax = jnp.maximum(0.0, 0.5 * trace + disc)
        lmin = jnp.maximum(0.0, 0.5 * trace - disc)
        smax, smin = jnp.sqrt(lmax), jnp.sqrt(lmin)

        s1, s2 = scaled_fun_2d(FUN_2D[self.fun], smax, smin, tau, self.coeffs)

        # eigenvectors of A^T A (2x2): (v11,v21) for lmax, (v12,v22) for lmin
        off = d12 != 0.0
        w11, w21 = lmax - d22, d12
        l1 = jnp.sqrt(w11 * w11 + w21 * w21)
        l1s = jnp.where(l1 > 0, l1, 1.0)
        w12, w22 = lmin - d22, d12
        l2 = jnp.sqrt(w12 * w12 + w22 * w22)
        l2s = jnp.where(l2 > 0, l2, 1.0)
        first_dom = d11 >= d22
        v11 = jnp.where(off, w11 / l1s, jnp.where(first_dom, 1.0, 0.0))
        v21 = jnp.where(off, w21 / l1s, jnp.where(first_dom, 0.0, 1.0))
        v12 = jnp.where(off, w12 / l2s, jnp.where(first_dom, 0.0, 1.0))
        v22 = jnp.where(off, w22 / l2s, jnp.where(first_dom, 1.0, 0.0))

        # T = V diag(s1/smax, s2/smin) V^T  (Sigma^+ Sigma_p)
        r1 = jnp.where(smax > 0, s1 / jnp.where(smax > 0, smax, 1.0), 0.0)
        r2 = jnp.where(smin > 0, s2 / jnp.where(smin > 0, smin, 1.0), 0.0)
        t11 = r1 * v11 * v11 + r2 * v12 * v12
        t12 = r1 * v11 * v21 + r2 * v12 * v22
        t21 = t12
        t22 = r1 * v21 * v21 + r2 * v22 * v22

        ra = a * t11 + b * t21
        rb = a * t12 + b * t22

        # degenerate case smax == 0 (zero matrix): result is diag(s1, s2)
        # embedded in the N x 2 matrix (elem_operation_singular_nx2.hpp:145-151)
        zero_case = smax <= 0
        ra = jnp.where(zero_case[None, :], 0.0, ra)
        rb = jnp.where(zero_case[None, :], 0.0, rb)
        ra = ra.at[0].set(jnp.where(zero_case, s1, ra[0]))
        rb = rb.at[1].set(jnp.where(zero_case, s2, rb[1]))

        return self.from_vectors(jnp.concatenate([ra, rb]))


# -- mass norm / comass ball --------------------------------------------------

_TRI4 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TRI5 = [
    (0, 1), (0, 2), (0, 3), (0, 4),
    (1, 2), (1, 3), (1, 4),
    (2, 3), (2, 4),
    (3, 4),
]


def _skew_from_components(vecs, n):
    """(dim, count) upper-triangle components -> (count, n, n) skew matrices.
    Component order matches the reference (row-major upper triangle,
    elem_operation_mass_norm.hpp:40-44, 115-120)."""
    tri = _TRI4 if n == 4 else _TRI5
    count = vecs.shape[1]
    M = jnp.zeros((count, n, n), dtype=vecs.dtype)
    for k, (i, j) in enumerate(tri):
        M = M.at[:, i, j].set(vecs[k])
        M = M.at[:, j, i].set(-vecs[k])
    return M


def _components_from_skew(M, n):
    tri = _TRI4 if n == 4 else _TRI5
    return jnp.stack([M[:, i, j] for (i, j) in tri])


def _mass_decompose_apply(M, n, transform):
    """Decompose skew M (count, n, n) into two orthogonal planes with
    weights sigma_k >= 0, apply ``transform(sigma)`` and rebuild.

    M Mᵀ is symmetric PSD with eigenvalues {σ1², σ1², σ2², σ2²(, 0)}.
    u1 = top eigenvector, v1 = M u1/σ1; u2 = the remaining eigenvector
    component orthogonal to span(u1, v1) (selected robustly among the
    next eigenvectors to survive σ1 == σ2 degeneracy), v2 = M u2/σ2.
    """
    S = einsum("cij,ckj->cik", M, M)  # M M^T
    _, W = jnp.linalg.eigh(S)  # ascending; take the last columns
    u1 = W[:, :, -1]  # (count, n) top eigenvector

    Mu1 = einsum("cij,cj->ci", M, u1)
    sig1 = jnp.linalg.norm(Mu1, axis=1)
    v1 = Mu1 / jnp.where(sig1 > 0, sig1, 1.0)[:, None]

    # candidates for u2: next three eigenvectors; pick the one with the
    # largest residual after projecting out u1 and v1
    cands = W[:, :, -2:-5:-1]  # (count, n, 3)
    proj_u = einsum("cnk,cn->ck", cands, u1)
    proj_v = einsum("cnk,cn->ck", cands, v1)
    resid = cands - u1[:, :, None] * proj_u[:, None, :] - v1[:, :, None] * proj_v[:, None, :]
    norms = jnp.linalg.norm(resid, axis=1)  # (count, 3)
    best = jnp.argmax(norms, axis=1)
    u2 = jnp.take_along_axis(resid, best[:, None, None], axis=2)[:, :, 0]
    nu2 = jnp.linalg.norm(u2, axis=1)
    u2 = u2 / jnp.where(nu2 > 0, nu2, 1.0)[:, None]

    Mu2 = einsum("cij,cj->ci", M, u2)
    sig2 = jnp.linalg.norm(Mu2, axis=1)
    v2 = Mu2 / jnp.where(sig2 > 0, sig2, 1.0)[:, None]

    s1, s2 = transform(sig1), transform(sig2)

    def plane(u, v):
        return einsum("ci,cj->cij", v, u) - einsum("ci,cj->cij", u, v)

    return s1[:, None, None] * plane(u1, v1) + s2[:, None, None] * plane(u2, v2)


@pytree_dataclass
class ProxElemMassNorm(ProxSeparableSum):
    """Prox of the (weighted) mass norm of 2-vectors in R^4 (dim 6) or R^5
    (dim 10), or — with conjugate=True — projection onto the comass unit
    ball (elem_operation_mass_norm.hpp; elem_operation:mass4/mass5/
    ind_comass4_ball/ind_comass5_ball)."""

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    n: int = static_field()  # 4 or 5
    interleaved: bool = static_field()
    conjugate: bool = static_field(default=False)
    cost: float = static_field(default=1.0)  # weight (mass4 only in ref)

    @property
    def dim(self):
        return 6 if self.n == 4 else 10

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        vecs = self.to_vectors(arg)  # (dim, count)
        tau = effective_tau(
            self.vector_tau(tau_diag), self.cost * tau_scal, invert_tau
        )
        tau = jnp.broadcast_to(tau, (self.count,))

        M = _skew_from_components(vecs, self.n)
        if self.conjugate:
            transform = lambda s: jnp.clip(s, -1.0, 1.0)
        else:
            transform = lambda s: jnp.sign(s) * jnp.maximum(jnp.abs(s) - tau, 0.0)
        out = _mass_decompose_apply(M, self.n, transform)
        return self.from_vectors(_components_from_skew(out, self.n))
