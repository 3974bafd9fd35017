"""Linear operator layer: block-structured K.

Re-design of /root/reference/include/prost/linop/
{linearoperator.hpp, block.hpp, dual_linearoperator.hpp}:

* A ``Block`` is a pure pair of functions on its local segment,
  ``apply(x_seg) -> y_seg_contribution`` and ``apply_adjoint(y_seg)``,
  plus vectorized ``row_sum(alpha)`` / ``col_sum(alpha)`` for the
  Pock-Chambolle preconditioner.  (The reference exposes scalar
  per-row/col sums, linearoperator.hpp:48-72; here they are whole-vector.)

* ``LinearOperator`` owns a grid of blocks with disjoint output rectangles
  (overlap validated like linearoperator.cu:84-125) and evaluates
  ``y = K x`` as a sum of block contributions via static slices +
  scatter-adds that XLA turns into fused dynamic-update-slices.

* ``DualLinearOperator`` is the -K^T view used by Problem::Dualize
  (dual_linearoperator.cu:25-94).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..common import pytree_dataclass, static_field
from ..config import ProstError


class Block:
    """Base for blocks; subclasses are pytree dataclasses with static
    row/col/nrows/ncols fields."""

    row: int
    col: int
    nrows: int
    ncols: int

    def apply(self, x_seg):
        """K_block @ x_seg, returns (nrows,) contribution."""
        raise NotImplementedError

    def apply_adjoint(self, y_seg):
        """K_block^T @ y_seg, returns (ncols,) contribution."""
        raise NotImplementedError

    def row_sum(self, alpha: float):
        """(nrows,) vector of sum_j |K_ij|^alpha."""
        raise NotImplementedError

    def col_sum(self, alpha: float):
        """(ncols,) vector of sum_i |K_ij|^alpha."""
        raise NotImplementedError


def _rects_overlap(a: Block, b: Block) -> bool:
    """Rectangle intersection test (linearoperator.cu:31-39)."""
    ax1, ax2 = a.col, a.col + a.ncols - 1
    ay1, ay2 = a.row, a.row + a.nrows - 1
    bx1, bx2 = b.col, b.col + b.ncols - 1
    by1, by2 = b.row, b.row + b.nrows - 1
    return ax1 <= bx2 and ax2 >= bx1 and ay1 <= by2 and ay2 >= by1


@pytree_dataclass
class LinearOperator:
    nrows: int = static_field()
    ncols: int = static_field()
    blocks: tuple = ()

    @staticmethod
    def create(blocks) -> "LinearOperator":
        """Validate non-overlap and compute the bounding size
        (linearoperator.cu:84-125)."""
        blocks = tuple(blocks)
        if not blocks:
            raise ProstError("LinearOperator: no blocks.")
        from .._native import host

        hit = host.check_block_overlap(
            [b.row for b in blocks], [b.col for b in blocks],
            [b.nrows for b in blocks], [b.ncols for b in blocks],
        )
        if hit is not None:
            a, b = blocks[hit[0]], blocks[hit[1]]
            raise ProstError(
                f"LinearOperator: blocks overlap at "
                f"({a.row},{a.col}) and ({b.row},{b.col})."
            )
        nrows = max(b.row + b.nrows for b in blocks)
        ncols = max(b.col + b.ncols for b in blocks)
        return LinearOperator(nrows=nrows, ncols=ncols, blocks=blocks)

    def apply(self, x):
        """y = K x."""
        y = jnp.zeros(self.nrows, dtype=x.dtype)
        if len(self.blocks) == 1:
            b = self.blocks[0]
            if b.row == 0 and b.nrows == self.nrows:
                return b.apply(x[b.col : b.col + b.ncols])
        for b in self.blocks:
            seg = x[b.col : b.col + b.ncols]
            y = y.at[b.row : b.row + b.nrows].add(b.apply(seg))
        return y

    def apply_adjoint(self, y):
        """x = K^T y."""
        x = jnp.zeros(self.ncols, dtype=y.dtype)
        if len(self.blocks) == 1:
            b = self.blocks[0]
            if b.col == 0 and b.ncols == self.ncols:
                return b.apply_adjoint(y[b.row : b.row + b.nrows])
        for b in self.blocks:
            seg = y[b.row : b.row + b.nrows]
            x = x.at[b.col : b.col + b.ncols].add(b.apply_adjoint(seg))
        return x

    def row_sum(self, alpha: float):
        from ..config import dtype

        s = jnp.zeros(self.nrows, dtype=dtype())
        for b in self.blocks:
            s = s.at[b.row : b.row + b.nrows].add(b.row_sum(alpha))
        return s

    def col_sum(self, alpha: float):
        from ..config import dtype

        s = jnp.zeros(self.ncols, dtype=dtype())
        for b in self.blocks:
            s = s.at[b.col : b.col + b.ncols].add(b.col_sum(alpha))
        return s


@pytree_dataclass
class DualLinearOperator:
    """View representing -K^T (dual_linearoperator.cu:25-94)."""

    child: LinearOperator = None

    @property
    def nrows(self):
        return self.child.ncols

    @property
    def ncols(self):
        return self.child.nrows

    @property
    def blocks(self):
        return self.child.blocks

    def apply(self, x):
        return -self.child.apply_adjoint(x)

    def apply_adjoint(self, y):
        return -self.child.apply(y)

    def row_sum(self, alpha: float):
        return self.child.col_sum(alpha)

    def col_sum(self, alpha: float):
        return self.child.row_sum(alpha)
