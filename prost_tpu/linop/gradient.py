"""Gradient stencil blocks (forward differences).

Counterparts of block_gradient2d.cu / block_gradient3d.cu: the
CUDA stencil kernels become shifted-subtraction on a reshaped 3D view, which
XLA fuses/vectorizes; under sharding, halo exchange replaces the implicit
global-memory neighbor reads (see prost_tpu/parallel).

Layout contract (block_gradient2d.cu:53-77):

* label_first=False: flat index = y + ny*x + nx*ny*l  -> view (L, nx, ny)
* label_first=True:  flat index = l + L*y + L*ny*x    -> view (nx, ny, L)

Forward output = [gx ; gy(; gl)] halves/thirds, each of input size; gx/gy
use Neumann boundaries (zero last difference).  The 3D block's third axis
is the label axis with a *Dirichlet* boundary: gl_{L-1} = -u_{L-1}
(block_gradient3d.cu:71-73).  The adjoint is minus the divergence.

Hardcoded preconditioner sums match the reference: gradient2d row_sum=2 /
col_sum=4 (block_gradient2d.cu:153-163), gradient3d row_sum=2 / col_sum=6.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..common import pytree_dataclass, static_field
from .base import Block


def fwd_diff(u, axis):
    """Forward difference with Neumann boundary (zero at the end)."""
    pad = [(0, 0)] * u.ndim
    pad[axis] = (0, 1)
    return jnp.pad(jnp.diff(u, axis=axis), pad)


def _slice_axis(a, axis, start, stop):
    """Static slice along one axis (lax.slice — unlike jnp.take with an
    index vector, static slices propagate through GSPMD without
    degenerating into all-gathers)."""
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(start, stop)
    return a[tuple(idx)]


def fwd_diff_adjoint(p, axis):
    """Adjoint of fwd_diff: (D^T p)_i = p_{i-1}[i>0] - p_i[i<n-1]."""
    body = _slice_axis(p, axis, 0, p.shape[axis] - 1)
    lead = jnp.pad(
        body, [(1, 0) if a == axis else (0, 0) for a in range(p.ndim)],
    )
    trail = jnp.pad(
        body, [(0, 1) if a == axis else (0, 0) for a in range(p.ndim)],
    )
    return lead - trail


def fwd_diff_dirichlet(u, axis):
    """Forward difference with Dirichlet boundary: last entry = -u_last."""
    shifted = jnp.pad(
        _slice_axis(u, axis, 1, u.shape[axis]),
        [(0, 1) if a == axis else (0, 0) for a in range(u.ndim)],
    )
    return shifted - u


def fwd_diff_dirichlet_adjoint(p, axis):
    """Adjoint of fwd_diff_dirichlet: (D^T p)_i = p_{i-1}[i>0] - p_i."""
    lead = jnp.pad(
        _slice_axis(p, axis, 0, p.shape[axis] - 1),
        [(1, 0) if a == axis else (0, 0) for a in range(p.ndim)],
    )
    return lead - p


@pytree_dataclass
class BlockGradient2D(Block):
    row: int = static_field()
    col: int = static_field()
    nx: int = static_field()
    ny: int = static_field()
    L: int = static_field()
    label_first: bool = static_field(default=False)

    @property
    def nrows(self):
        return 2 * self.nx * self.ny * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _view(self, x):
        if self.label_first:
            return x.reshape(self.nx, self.ny, self.L)
        return x.reshape(self.L, self.nx, self.ny)

    def _axes(self):
        # (x axis, y axis) in the 3D view
        return (0, 1) if self.label_first else (1, 2)

    def apply(self, x_seg):
        u = self._view(x_seg)
        ax, ay = self._axes()
        gx = fwd_diff(u, ax).reshape(-1)
        gy = fwd_diff(u, ay).reshape(-1)
        return jnp.concatenate([gx, gy])

    def apply_adjoint(self, y_seg):
        n = self.ncols
        px = self._view(y_seg[:n])
        py = self._view(y_seg[n:])
        ax, ay = self._axes()
        return (fwd_diff_adjoint(px, ax) + fwd_diff_adjoint(py, ay)).reshape(-1)

    def row_sum(self, alpha: float):
        from ..config import dtype

        return jnp.full(self.nrows, 2.0, dtype=dtype())

    def col_sum(self, alpha: float):
        from ..config import dtype

        return jnp.full(self.ncols, 4.0, dtype=dtype())


@pytree_dataclass
class BlockGradient3D(Block):
    """Gradient with an additional label-direction difference (Dirichlet at
    the far label boundary), used by the tight multilabel relaxation."""

    row: int = static_field()
    col: int = static_field()
    nx: int = static_field()
    ny: int = static_field()
    L: int = static_field()
    label_first: bool = static_field(default=False)

    @property
    def nrows(self):
        return 3 * self.nx * self.ny * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _view(self, x):
        if self.label_first:
            return x.reshape(self.nx, self.ny, self.L)
        return x.reshape(self.L, self.nx, self.ny)

    def _axes(self):
        # (x, y, label) axes in the 3D view
        return (0, 1, 2) if self.label_first else (1, 2, 0)

    def apply(self, x_seg):
        u = self._view(x_seg)
        ax, ay, al = self._axes()
        gx = fwd_diff(u, ax).reshape(-1)
        gy = fwd_diff(u, ay).reshape(-1)
        gl = fwd_diff_dirichlet(u, al).reshape(-1)
        return jnp.concatenate([gx, gy, gl])

    def apply_adjoint(self, y_seg):
        n = self.ncols
        px = self._view(y_seg[:n])
        py = self._view(y_seg[n : 2 * n])
        pl = self._view(y_seg[2 * n :])
        ax, ay, al = self._axes()
        return (
            fwd_diff_adjoint(px, ax)
            + fwd_diff_adjoint(py, ay)
            + fwd_diff_dirichlet_adjoint(pl, al)
        ).reshape(-1)

    def row_sum(self, alpha: float):
        from ..config import dtype

        return jnp.full(self.nrows, 2.0, dtype=dtype())

    def col_sum(self, alpha: float):
        from ..config import dtype

        return jnp.full(self.ncols, 6.0, dtype=dtype())
