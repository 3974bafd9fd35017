"""Standalone prox operators: zero, SOC, halfspace, quadratic epigraph,
index-set sum constraints, range projection.

Counterparts of /root/reference/src/prox/prox_{zero, ind_soc,
ind_halfspace, ind_epi_quad, ind_sum, ind_range}.cu — each CUDA kernel
becomes a vectorized jnp expression over a (dim, count) view.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..common import einsum, matmul, pytree_dataclass, static_field
from ..config import ProstError
from .base import Prox, ProxSeparableSum


@pytree_dataclass
class ProxZero(Prox):
    """Identity: prox of the zero function (prox_zero.cu:36-48)."""

    index: int = static_field()
    size: int = static_field()

    @property
    def diagsteps(self) -> bool:
        return True  # prox_zero.cu:26-29

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        return arg


@pytree_dataclass
class ProxIndSOC(ProxSeparableSum):
    """Projection onto the second-order cone {(x, y): alpha ||x||_2 <= y}.

    Layout (prox_ind_soc.cu:34-38): the dim-1 x-components are stored
    planar, the scalar y last — i.e. segment = [x_1..., x_2..., ..., y...].
    Closed-form three-case projection (prox_ind_soc.cu:44-77).  The
    reference only supports alpha = 1 (prox_ind_soc.cu:116-119); here any
    alpha > 0 works: with t = (||x||/alpha + y) / (1 + 1/alpha^2), the
    boundary projection is (t/alpha) * x/||x|| with height t.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    alpha: float = static_field(default=1.0)

    @property
    def interleaved(self):
        return False

    def __post_init__(self):
        if self.alpha <= 0.0:
            raise ProstError("ProxIndSOC: alpha must be positive.")

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        al = self.alpha
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[: self.dim - 1], vecs[self.dim - 1]
        norm = jnp.sqrt(jnp.sum(x0 * x0, axis=0))
        safe_norm = jnp.where(norm > 0, norm, 1.0)
        t = (norm / al + y0) / (1.0 + 1.0 / al**2)
        fac = (t / al) / safe_norm

        inside = al * norm <= y0
        polar = norm <= -al * y0  # inside the polar cone -> project to 0
        scale = jnp.where(inside, 1.0, jnp.where(polar, 0.0, fac))
        x = x0 * scale[None, :]
        y = jnp.where(inside, y0, jnp.where(polar, 0.0, t))
        return jnp.concatenate([x, y[None, :]]).reshape(self.size)


@pytree_dataclass
class ProxIndHalfspace(ProxSeparableSum):
    """Projection onto {x : <a, x> <= b} per dim-vector
    (prox_ind_halfspace.cu:30-89).

    a has size dim (shared) or count*dim (per-instance, planar layout);
    b has size 1 or count.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    a: jnp.ndarray = None
    b: jnp.ndarray = None

    @property
    def interleaved(self):
        return False

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        v = arg.reshape(self.dim, self.count)
        if self.a.size == self.dim:
            a = jnp.asarray(self.a).reshape(self.dim, 1)
        else:
            a = jnp.asarray(self.a).reshape(self.dim, self.count)
        b = jnp.asarray(self.b).reshape(-1)  # (1,) or (count,)

        sq_norm = jnp.sum(a * a, axis=0)
        iprod = jnp.sum(a * v, axis=0)
        # projection onto the halfspace (inequality): only move if violated
        s = jnp.maximum(iprod - b, 0.0) / sq_norm
        return (v - s[None, :] * a).reshape(self.size)


def _project_parabola_nd(x0_sq_norm, x0_norm, y0, alpha):
    """Scale factor + height for projecting (x0, y0) onto the epigraph of
    y >= alpha ||x||^2, via the closed-form depressed-cubic root
    (helper.hpp:44-105).  Returns (v, y): x = (v/(2 alpha)) * x0/||x0||.
    """
    a = 2.0 * alpha * x0_norm
    b = 2.0 * (1.0 - 2.0 * alpha * y0) / 3.0

    # discriminant, written to avoid cancellation for b < 0
    sq = jnp.power(jnp.abs(b), 1.5)
    d = jnp.where(b < 0, (a - sq) * (a + sq), a * a + b * b * b)

    # d >= 0: single real root via Cardano
    c = jnp.cbrt(a + jnp.sqrt(jnp.maximum(d, 0.0)))
    v_pos = jnp.where(jnp.abs(c) > 1e-6, c - b / c, 0.0)

    # d < 0: trigonometric form (three real roots; take the relevant one)
    safe_sq = jnp.where(sq > 0, sq, 1.0)
    ratio = jnp.clip(a / safe_sq, -1.0, 1.0)
    v_neg = 2.0 * jnp.sqrt(jnp.maximum(-b, 0.0)) * jnp.cos(jnp.arccos(ratio) / 3.0)

    return jnp.where(d >= 0, v_pos, v_neg)


@pytree_dataclass
class ProxIndEpiQuad(ProxSeparableSum):
    """Projection onto the epigraph of y >= a||x||^2 + <b, x> + c
    (prox_ind_epi_quad.cu:42-77): complete the square, project onto the
    standard parabola epigraph, undo the shift.

    Layout as SOC: dim-1 x-components planar, then y.  a, c are scalars or
    (count,); b is (dim-1,) * count planar.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    a: jnp.ndarray = None
    b: jnp.ndarray = None
    c: jnp.ndarray = None

    @property
    def interleaved(self):
        return False

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        d = self.dim - 1
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[:d], vecs[d]

        a = jnp.asarray(self.a).reshape(-1)  # (1,) or (count,)
        c = jnp.asarray(self.c).reshape(-1)
        b = jnp.asarray(self.b).reshape(d, -1)  # (d, 1) or (d, count)

        shift = b / (2.0 * a)
        xs = x0 + shift
        sq_norm_b = jnp.sum(b * b, axis=0)
        ys = y0 - c + sq_norm_b / (4.0 * a)

        sq_norm_xs = jnp.sum(xs * xs, axis=0)
        norm_xs = jnp.sqrt(sq_norm_xs)
        inside = ys >= a * sq_norm_xs

        v = _project_parabola_nd(sq_norm_xs, norm_xs, ys, a)
        safe_norm = jnp.where(norm_xs > 0, norm_xs, 1.0)
        scale = jnp.where(norm_xs > 0, (v / (2.0 * a)) / safe_norm, 0.0)
        xp = xs * scale[None, :]
        yp = a * jnp.sum(xp * xp, axis=0)

        x_out = jnp.where(inside, x0, xp - shift)
        y_out = jnp.where(inside, y0, yp + c - sq_norm_b / (4.0 * a))
        return jnp.concatenate([x_out, y_out[None, :]]).reshape(self.size)


@pytree_dataclass
class ProxIndEpiPolyhedral(ProxSeparableSum):
    """Projection onto the epigraph of a polyhedral (max-of-affine) function

        f(x) = max_i ( <a_i, x> - b_i ),   i.e. onto {(x, y): A x - y <= b },

    per dim-vector with dim = d + 1 (x planar, then y) — the prox the
    reference *tests* (matlab/+prost/+test/test_prox_sum_ind_epi_polyhedral.m,
    quadprog oracle with A = [coeff_a, -1], b = coeff_b) but never ships a
    kernel for (no factory.cpp registry entry).

    Solve: the dual of the projection QP is the non-negative QP

        min_{lam >= 0}  1/2 lam^T M lam - lam^T q,
        M = Atil Atil^T,  q = Atil z0 - b,  Atil = [A, -1],  z0 = (x0, y0),

    recovered by z = z0 - Atil^T lam.  Solved by batched projected SOR
    (over-relaxed Gauss-Seidel coordinate descent, exact per-coordinate
    minimization at ``omega`` = 1), all `count` problems advancing in
    lockstep along the count axis; the per-point constraint counts may be
    ragged — padded rows carry mask 0 and never activate.  A feasible
    point (all q <= 0) keeps lam = 0, so the projection is the identity
    there with no special-casing.

    Convergence / accuracy:

    * The sweep loop is a ``lax.while_loop`` that exits when the largest
      per-coordinate update of a full sweep (== the coordinate-wise
      projected-gradient residual scaled by omega/M_ii) falls below
      ``tol * (1 + max|q|)``, capped at ``sweeps`` sweeps.  w = M lam is
      refreshed from scratch each sweep so rounding drift cannot grow
      with the sweep count.
    * The dual QP is degenerate when m >> d+1 (rank(M) = d+1): plain
      Gauss-Seidel then converges slowly when near-parallel constraints
      are active; ``omega`` near 2 (projected SOR, convergent for any
      omega in (0, 2)) accelerates exactly that regime — measured ~5
      orders of magnitude tighter after 20k sweeps at omega=1.9 vs 1.0
      on the reference test's hardest instances.
    * At the reference test's data scale (x0 ~ 1000*randn, m=25, 1e-3
      absolute norm check — test_prox_sum_ind_epi_polyhedral.m:15-16,52)
      the bar is ~1e-6 *relative*: f32 floors at ~2e-3 absolute there
      (eps_f32 * scale * sqrt(ops)); in float64 mode
      (``prost_tpu.set_dtype(jnp.float64)``) the bar is met with margin
      (~3e-6, sweeps=20000, omega=1.9 — the reference itself runs
      double, matlab/+prost/private/config.hpp:6-7).  See
      tests/test_prox_epi_polyhedral.py::test_epi_polyhedral_reference_scale.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()  # d + 1
    sweeps: int = static_field(default=400)
    tol: float = static_field(default=5e-7)
    omega: float = static_field(default=1.7)  # SOR over-relaxation
    a: jnp.ndarray = None      # (m, d, count) padded coefficient rows
    b: jnp.ndarray = None      # (m, count)
    mask: jnp.ndarray = None   # (m, count) 1.0 = real constraint, 0.0 = pad
    M: jnp.ndarray = None      # (m, m, count) Gram matrix of [A, -1] rows
    Mii: jnp.ndarray = None    # (m, count) diag(M), padded entries set to 1

    @staticmethod
    def create(index, size, count, dim, a, b, mask=None, sweeps=400,
               tol=5e-7, omega=1.7):
        """a: (m, d, count) or (m, d) shared; b: (m, count) or (m,)."""
        a = jnp.asarray(a)
        b = jnp.asarray(b)
        if a.ndim == 2:
            a = jnp.broadcast_to(a[:, :, None], a.shape + (count,))
        if b.ndim == 1:
            b = jnp.broadcast_to(b[:, None], b.shape + (count,))
        m = a.shape[0]
        if mask is None:
            mask = jnp.ones((m, count), a.dtype)
        else:
            mask = jnp.asarray(mask, a.dtype)
        # Gram of the augmented rows (a_i, -1): M_ij = <a_i, a_j> + 1,
        # zeroed outside the active block so padded lambdas stay inert.
        M = einsum("idc,jdc->ijc", a, a) + 1.0
        M = M * mask[:, None, :] * mask[None, :, :]
        eye = jnp.eye(m, dtype=a.dtype)[:, :, None]
        Mii = einsum("iic->ic", M)
        Mii_safe = jnp.where(mask > 0, Mii, 1.0)
        M = jnp.where((mask[:, None, :] * mask[None, :, :]) > 0, M, eye)
        return ProxIndEpiPolyhedral(
            index=index, size=size, count=count, dim=dim, sweeps=sweeps,
            tol=tol, omega=omega, a=a, b=b, mask=mask, M=M, Mii=Mii_safe,
        )

    @property
    def interleaved(self):
        return False

    @property
    def diagsteps(self) -> bool:
        return True  # projection: tau is irrelevant

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        from jax import lax

        d = self.dim - 1
        m = self.a.shape[0]
        vecs = arg.reshape(self.dim, self.count)
        x0, y0 = vecs[:d], vecs[d]  # (d, count), (count,)

        # q_i = <a_i, x0> - y0 - b_i, masked so padded rows never activate
        q = (einsum("idc,dc->ic", self.a, x0) - y0[None, :] - self.b)
        q = q * self.mask

        def coord(i, carry):
            lam, w, dmax = carry
            g = lax.dynamic_slice_in_dim(w, i, 1, 0)[0] - \
                lax.dynamic_slice_in_dim(q, i, 1, 0)[0]
            lam_i = lax.dynamic_slice_in_dim(lam, i, 1, 0)[0]
            mii = lax.dynamic_slice_in_dim(self.Mii, i, 1, 0)[0]
            new = jnp.maximum(0.0, lam_i - self.omega * g / mii) \
                * lax.dynamic_slice_in_dim(self.mask, i, 1, 0)[0]
            delta = new - lam_i
            mcol = lax.dynamic_slice_in_dim(self.M, i, 1, 1)[:, 0]  # (m, count)
            w = w + mcol * delta[None, :]
            lam = lax.dynamic_update_slice_in_dim(lam, new[None], i, 0)
            return lam, w, jnp.maximum(dmax, jnp.max(jnp.abs(delta)))

        lam0 = jnp.zeros_like(q)
        dtol = self.tol * (1.0 + jnp.max(jnp.abs(q)))

        def sweep(carry):
            lam, _, k, _ = carry
            # refresh w = M lam from scratch each sweep: the incremental
            # updates inside `coord` accumulate rounding drift that would
            # otherwise grow without bound with the sweep count
            w = einsum("ijc,jc->ic", self.M, lam)
            lam, w, dmax = lax.fori_loop(
                0, m, coord, (lam, w, jnp.zeros((), lam.dtype)))
            return lam, w, k + 1, dmax

        def not_done(carry):
            _, _, k, dmax = carry
            return (k < self.sweeps) & (dmax > dtol)

        lam, _, _, _ = lax.while_loop(
            not_done, sweep,
            (lam0, lam0, jnp.asarray(0, jnp.int32),
             jnp.asarray(jnp.inf, lam0.dtype)))

        x = x0 - einsum("ic,idc->dc", lam, self.a)
        y = y0 + jnp.sum(lam, axis=0)
        return jnp.concatenate([x, y[None, :]]).reshape(self.size)


@pytree_dataclass
class ProxIndSum(Prox):
    """Projection onto {x : sum over index set(s) = fixed total}, identity
    elsewhere, with step-size-weighted correction (prox_ind_sum.cu:33-69).

    inds is a (count, dim) int array of *local* indices into the segment;
    the tau-weighted projection respects diagonal step sizes:

        res[I_j] = arg[I_j] - tau[I_j] * (sum(arg[I]) - total) / sum(tau[I])

    Optionally a second constraint set (inds2/sum2) is applied on top,
    mirroring the `two_` flag.
    """

    index: int = static_field()
    size: int = static_field()
    count: int = static_field()
    dim: int = static_field()
    sum_target: float = static_field(default=1.0)
    count2: int = static_field(default=0)
    dim2: int = static_field(default=0)
    sum_target2: float = static_field(default=1.0)
    inds: jnp.ndarray = None
    inds2: jnp.ndarray = None

    @property
    def diagsteps(self) -> bool:
        return True

    def _apply_set(self, res, arg, taus, inds, count, dim, total):
        inds = inds.reshape(count, dim)
        a = arg[inds]  # (count, dim) gather
        t = taus[inds]
        corr = (jnp.sum(a, axis=1) - total) / jnp.sum(t, axis=1)
        upd = a - t * corr[:, None]
        return res.at[inds.reshape(-1)].set(upd.reshape(-1))

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        taus = tau_diag * tau_scal
        if invert_tau:
            taus = 1.0 / taus
        res = arg  # identity on untouched indices (prox_ind_sum.cu:112-114)
        res = self._apply_set(
            res, arg, taus, self.inds, self.count, self.dim, self.sum_target
        )
        if self.inds2 is not None:
            res = self._apply_set(
                res, arg, taus, self.inds2, self.count2, self.dim2, self.sum_target2
            )
        return res


@pytree_dataclass
class ProxIndRange(Prox):
    """Projection onto range(A) for a dense OR sparse matrix A:
    result = A (A^T A)^{-1} A^T arg (prox_ind_range.cu:195-305).

    The reference accepts sparse A (cusparse csrmv, prox_ind_range.cu:
    195-305) and an optional precomputed AA = A^T A which it Cholesky-
    factorizes with cuSOLVER; here both contracts are kept: pass a
    scipy.sparse matrix (or a jax BCOO) and the matvecs run as BCOO
    dot-generals (gather/segment-sum) with O(nnz + k^2) memory
    instead of densifying the (size, k) matrix; pass a dense array and
    the matvecs are dense matrix products (the right call for DCT-like bases with
    ncols << nrows).  The (k, k) Cholesky factor is computed once at
    initialization and rides the pytree.
    """

    index: int = static_field()
    size: int = static_field()
    A: jnp.ndarray = None  # (size, k) dense array or sparse.BCOO
    chol: jnp.ndarray = None  # lower Cholesky factor of A^T A, (k, k)

    @staticmethod
    def create(index, size, A, AA=None):
        from ..config import dtype
        dt = dtype()
        try:
            import scipy.sparse as ssp
            is_scipy = ssp.issparse(A)
        except ImportError:  # pragma: no cover
            is_scipy = False
        from jax.experimental import sparse as jsparse

        if is_scipy:
            if AA is None:
                AA = np.asarray((A.T @ A).todense())
            B = jsparse.BCOO.from_scipy_sparse(A.tocoo())
            A = jsparse.BCOO((B.data.astype(dt), B.indices), shape=B.shape)
        elif isinstance(A, jsparse.BCOO):
            if AA is None:
                AA = np.asarray((A.T @ A).todense())
            A = jsparse.BCOO((A.data.astype(dt), A.indices), shape=A.shape)
        else:
            A = jnp.asarray(A, dt)
            if AA is None:
                AA = matmul(A.T, A)
        chol = jnp.linalg.cholesky(jnp.asarray(AA, dt))
        return ProxIndRange(index=index, size=size, A=A, chol=chol)

    @property
    def diagsteps(self) -> bool:
        return True  # projection ignores tau entirely

    def eval_local(self, arg, tau_diag, tau_scal, invert_tau):
        from jax.scipy.linalg import cho_solve

        atb = _range_matvec(self.A.T, arg)
        coef = cho_solve((self.chol, True), atb)
        return _range_matvec(self.A, coef)


def _range_matvec(A, v):
    """A @ v for ProxIndRange's dense or BCOO A.  The sparse product is a
    gather and segment sum, exact in the working dtype; the dense one is a
    matrix product and asks for full precision."""
    from jax.experimental import sparse as jsparse

    if isinstance(A, jsparse.BCOO):
        return A @ v
    return matmul(A, v)
