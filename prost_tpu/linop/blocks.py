"""Concrete block types: sparse, dense, diags, kron variants, zero.

Re-designs of /root/reference/src/linop/block_{sparse, dense,
diags, sparse_kron_id, id_kron_sparse, dense_kron_id, id_kron_dense,
zero}.cu:

* BlockSparse keeps two sorted COO copies (row-major for forward,
  col-major for adjoint) — the analog of the reference's CSR+CSC pair
  (block_sparse.cu:34-67) — and evaluates with gather + segment-sum.

* The kron blocks exploit that kron(M, I_d) / kron(I_n, M) matvecs are
  reshaped matrix products: X = x.reshape(...); Y = M @ X (or X @ M^T).
  M is stored *dense* regardless of how it was given: the per-pixel
  coupling matrices these blocks express are small (L x L'), and a small
  dense product beats any scatter-based sparse kernel.
  (The reference's kernels walk CSR rows per thread,
  block_sparse_kron_id.cu:40-51; it also downcasts values to float in
  double mode — we keep the working dtype.)

* Every matrix product runs at full precision (``common.matmul``).

* BlockDiags evaluates a banded matrix as a static sum of shifted scaled
  slices (the reference walks diagonals per row from __constant__ memory,
  block_diags.cu:35-95, with a 1024-entry cap we don't need).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..common import matmul, pytree_dataclass, static_field
from ..config import dtype as config_dtype
from .base import Block


def _as_coo(nrows, ncols, matrix):
    """Accept scipy.sparse, dense ndarray, or (rows, cols, vals) triple;
    return numpy COO arrays."""
    if isinstance(matrix, tuple) and len(matrix) == 3:
        r, c, v = matrix
        return np.asarray(r), np.asarray(c), np.asarray(v)
    if hasattr(matrix, "tocoo"):
        coo = matrix.tocoo()
        return coo.row, coo.col, coo.data
    m = np.asarray(matrix)
    r, c = np.nonzero(m)
    return r, c, m[r, c]


@pytree_dataclass
class BlockSparse(Block):
    """General sparse matrix block."""

    row: int = static_field()
    col: int = static_field()
    nrows: int = static_field()
    ncols: int = static_field()
    # row-sorted COO (forward) and col-sorted COO (adjoint)
    rows_f: jnp.ndarray = None
    cols_f: jnp.ndarray = None
    vals_f: jnp.ndarray = None
    rows_a: jnp.ndarray = None
    cols_a: jnp.ndarray = None
    vals_a: jnp.ndarray = None

    @staticmethod
    def create(row, col, nrows, ncols, matrix) -> "BlockSparse":
        from .._native import host

        r, c, v = _as_coo(nrows, ncols, matrix)
        r = np.ascontiguousarray(r, np.int32)
        c = np.ascontiguousarray(c, np.int32)
        fwd = host.coo_sort_perm(r, c)
        adj = host.coo_sort_perm(c, r)
        dt = config_dtype()
        return BlockSparse(
            row=row, col=col, nrows=nrows, ncols=ncols,
            rows_f=jnp.asarray(r[fwd], dtype=jnp.int32),
            cols_f=jnp.asarray(c[fwd], dtype=jnp.int32),
            vals_f=jnp.asarray(v[fwd], dtype=dt),
            rows_a=jnp.asarray(r[adj], dtype=jnp.int32),
            cols_a=jnp.asarray(c[adj], dtype=jnp.int32),
            vals_a=jnp.asarray(v[adj], dtype=dt),
        )

    def apply(self, x_seg):
        import jax

        prod = self.vals_f * x_seg[self.cols_f]
        return jax.ops.segment_sum(
            prod, self.rows_f, num_segments=self.nrows, indices_are_sorted=True
        )

    def apply_adjoint(self, y_seg):
        import jax

        prod = self.vals_a * y_seg[self.rows_a]
        return jax.ops.segment_sum(
            prod, self.cols_a, num_segments=self.ncols, indices_are_sorted=True
        )

    def row_sum(self, alpha: float):
        import jax

        return jax.ops.segment_sum(
            jnp.abs(self.vals_f) ** alpha,
            self.rows_f,
            num_segments=self.nrows,
            indices_are_sorted=True,
        )

    def col_sum(self, alpha: float):
        import jax

        return jax.ops.segment_sum(
            jnp.abs(self.vals_a) ** alpha,
            self.cols_a,
            num_segments=self.ncols,
            indices_are_sorted=True,
        )


@pytree_dataclass
class BlockDense(Block):
    """Dense matrix block (block_dense.cu): a dense matvec."""

    row: int = static_field()
    col: int = static_field()
    nrows: int = static_field()
    ncols: int = static_field()
    data: jnp.ndarray = None  # (nrows, ncols)

    @staticmethod
    def create(row, col, matrix) -> "BlockDense":
        m = jnp.asarray(matrix, dtype=config_dtype())
        return BlockDense(row=row, col=col, nrows=m.shape[0], ncols=m.shape[1], data=m)

    def apply(self, x_seg):
        return matmul(self.data, x_seg)

    def apply_adjoint(self, y_seg):
        return matmul(self.data.T, y_seg)

    def row_sum(self, alpha: float):
        return jnp.sum(jnp.abs(self.data) ** alpha, axis=1)

    def col_sum(self, alpha: float):
        return jnp.sum(jnp.abs(self.data) ** alpha, axis=0)


@pytree_dataclass
class BlockDiags(Block):
    """Banded matrix with constant-valued diagonals (block_diags.cu).

    offsets: tuple of ints (column offset of each diagonal), factors: the
    constant value on each diagonal.  y[r] += f_k * x[r + ofs_k].
    """

    row: int = static_field()
    col: int = static_field()
    nrows: int = static_field()
    ncols: int = static_field()
    offsets: tuple = static_field(default=())
    factors: jnp.ndarray = None  # (ndiags,)

    @staticmethod
    def create(row, col, nrows, ncols, factors, offsets) -> "BlockDiags":
        offsets = tuple(int(o) for o in np.asarray(offsets).ravel())
        return BlockDiags(
            row=row, col=col, nrows=nrows, ncols=ncols, offsets=offsets,
            factors=jnp.asarray(np.asarray(factors).ravel(), dtype=config_dtype()),
        )

    def _ranges(self):
        """Valid output-row range [r0, r1) of each diagonal."""
        for k, ofs in enumerate(self.offsets):
            r0 = max(0, -ofs)
            r1 = min(self.nrows, self.ncols - ofs)
            if r1 > r0:
                yield k, ofs, r0, r1

    def apply(self, x_seg):
        y = jnp.zeros(self.nrows, dtype=x_seg.dtype)
        for k, ofs, r0, r1 in self._ranges():
            y = y.at[r0:r1].add(self.factors[k] * x_seg[r0 + ofs : r1 + ofs])
        return y

    def apply_adjoint(self, y_seg):
        x = jnp.zeros(self.ncols, dtype=y_seg.dtype)
        for k, ofs, r0, r1 in self._ranges():
            x = x.at[r0 + ofs : r1 + ofs].add(self.factors[k] * y_seg[r0:r1])
        return x

    def row_sum(self, alpha: float):
        s = jnp.zeros(self.nrows, dtype=config_dtype())
        for k, ofs, r0, r1 in self._ranges():
            s = s.at[r0:r1].add(jnp.abs(self.factors[k]) ** alpha)
        return s

    def col_sum(self, alpha: float):
        s = jnp.zeros(self.ncols, dtype=config_dtype())
        for k, ofs, r0, r1 in self._ranges():
            s = s.at[r0 + ofs : r1 + ofs].add(jnp.abs(self.factors[k]) ** alpha)
        return s


@pytree_dataclass
class BlockKronId(Block):
    """K = kron(M, I_d): y.reshape(m, d) = M @ x.reshape(c, d).

    Covers the registry kinds sparse_kron_id and dense_kron_id
    (block_sparse_kron_id.cu, block_dense_kron_id.cu); M is densified.
    """

    row: int = static_field()
    col: int = static_field()
    diaglength: int = static_field()
    data: jnp.ndarray = None  # (m, c) dense

    @staticmethod
    def create(row, col, diaglength, matrix) -> "BlockKronId":
        if hasattr(matrix, "toarray"):
            matrix = matrix.toarray()
        m = jnp.asarray(matrix, dtype=config_dtype())
        return BlockKronId(row=row, col=col, diaglength=diaglength, data=m)

    @property
    def nrows(self):
        return self.data.shape[0] * self.diaglength

    @property
    def ncols(self):
        return self.data.shape[1] * self.diaglength

    def apply(self, x_seg):
        X = x_seg.reshape(self.data.shape[1], self.diaglength)
        return matmul(self.data, X).reshape(-1)

    def apply_adjoint(self, y_seg):
        Y = y_seg.reshape(self.data.shape[0], self.diaglength)
        return matmul(self.data.T, Y).reshape(-1)

    def row_sum(self, alpha: float):
        per_row = jnp.sum(jnp.abs(self.data) ** alpha, axis=1)
        return jnp.repeat(per_row, self.diaglength)

    def col_sum(self, alpha: float):
        per_col = jnp.sum(jnp.abs(self.data) ** alpha, axis=0)
        return jnp.repeat(per_col, self.diaglength)


@pytree_dataclass
class BlockIdKron(Block):
    """K = kron(I_n, M): y.reshape(n, m) = x.reshape(n, c) @ M^T.

    Covers id_kron_sparse and id_kron_dense (block_id_kron_sparse.cu,
    block_id_kron_dense.cu); M is densified.
    """

    row: int = static_field()
    col: int = static_field()
    ncopies: int = static_field()
    data: jnp.ndarray = None  # (m, c) dense

    @staticmethod
    def create(row, col, ncopies, matrix) -> "BlockIdKron":
        if hasattr(matrix, "toarray"):
            matrix = matrix.toarray()
        m = jnp.asarray(matrix, dtype=config_dtype())
        return BlockIdKron(row=row, col=col, ncopies=ncopies, data=m)

    @property
    def nrows(self):
        return self.data.shape[0] * self.ncopies

    @property
    def ncols(self):
        return self.data.shape[1] * self.ncopies

    def apply(self, x_seg):
        X = x_seg.reshape(self.ncopies, self.data.shape[1])
        return matmul(X, self.data.T).reshape(-1)

    def apply_adjoint(self, y_seg):
        Y = y_seg.reshape(self.ncopies, self.data.shape[0])
        return matmul(Y, self.data).reshape(-1)

    def row_sum(self, alpha: float):
        per_row = jnp.sum(jnp.abs(self.data) ** alpha, axis=1)
        return jnp.tile(per_row, self.ncopies)

    def col_sum(self, alpha: float):
        per_col = jnp.sum(jnp.abs(self.data) ** alpha, axis=0)
        return jnp.tile(per_col, self.ncopies)


@pytree_dataclass
class BlockZero(Block):
    """Structural zero block (block_zero.cu)."""

    row: int = static_field()
    col: int = static_field()
    nrows: int = static_field()
    ncols: int = static_field()

    def apply(self, x_seg):
        return jnp.zeros(self.nrows, dtype=x_seg.dtype)

    def apply_adjoint(self, y_seg):
        return jnp.zeros(self.ncols, dtype=y_seg.dtype)

    def row_sum(self, alpha: float):
        return jnp.zeros(self.nrows, dtype=config_dtype())

    def col_sum(self, alpha: float):
        return jnp.zeros(self.ncols, dtype=config_dtype())
