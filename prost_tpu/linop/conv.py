"""2D convolution block: blur operators as convolutions.

The reference has no convolution block — its deblurring example builds a
giant sparse convmtx2 matrix and multiplies with cuSPARSE
(example_deblurring.m:33-37).  Here the same operator is a direct
``lax.conv_general_dilated`` call (no index traffic; XLA hands it to the
platform's convolution library):

    apply(u)          = full 2D convolution of each channel with the kernel
                        (ny2, nx2) = (ny + ky - 1, nx + kx - 1), identical
                        to MATLAB convmtx2 in the examples' column-major
                        (y fastest) layout
    apply_adjoint(v)  = valid cross-correlation with the same kernel

Channels (L) convolve independently (kron(I_L, B) semantics).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..common import HIGHEST, pytree_dataclass, static_field
from ..config import dtype as config_dtype
from .base import Block


@pytree_dataclass
class BlockConv2D(Block):
    row: int = static_field()
    col: int = static_field()
    nx: int = static_field()
    ny: int = static_field()
    L: int = static_field()
    kx: int = static_field()
    ky: int = static_field()
    kernel: jnp.ndarray = None  # (ky, kx)

    @staticmethod
    def create(row, col, nx, ny, L, kernel) -> "BlockConv2D":
        """kernel is (ky, kx) in image convention (rows = y); it is stored
        transposed to (kx, ky) because the internal plane view is (x, y)
        (flat index = y + ny*x + nx*ny*c, the examples' column-major
        contract)."""
        k = jnp.asarray(np.asarray(kernel).T, dtype=config_dtype())
        return BlockConv2D(row=row, col=col, nx=nx, ny=ny, L=L,
                           kx=k.shape[0], ky=k.shape[1], kernel=k)

    @property
    def nx2(self):
        return self.nx + self.kx - 1

    @property
    def ny2(self):
        return self.ny + self.ky - 1

    @property
    def nrows(self):
        return self.nx2 * self.ny2 * self.L

    @property
    def ncols(self):
        return self.nx * self.ny * self.L

    def _conv(self, img, kernel, padding):
        # img: (L, H, W) -> NCHW with C=1; one shared kernel
        out = lax.conv_general_dilated(
            img[:, None, :, :],
            kernel[None, None, :, :],
            window_strides=(1, 1),
            padding=padding,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=HIGHEST,
        )
        return out[:, 0]

    def apply(self, x_seg):
        u = x_seg.reshape(self.L, self.nx, self.ny)
        # full convolution: flip kernel, pad input by kernel-1 on both sides
        k = jnp.flip(self.kernel, (0, 1))
        out = self._conv(
            u, k,
            [(self.kx - 1, self.kx - 1), (self.ky - 1, self.ky - 1)],
        )
        return out.reshape(-1)

    def apply_adjoint(self, y_seg):
        v = y_seg.reshape(self.L, self.nx2, self.ny2)
        # adjoint of full convolution = valid cross-correlation
        out = self._conv(v, self.kernel, [(0, 0), (0, 0)])
        return out.reshape(-1)

    def row_sum(self, alpha: float):
        ones = jnp.ones((self.L, self.nx, self.ny), dtype=config_dtype())
        k = jnp.abs(jnp.flip(self.kernel, (0, 1))) ** alpha
        out = self._conv(
            ones, k,
            [(self.kx - 1, self.kx - 1), (self.ky - 1, self.ky - 1)],
        )
        return out.reshape(-1)

    def col_sum(self, alpha: float):
        ones = jnp.ones((self.L, self.nx2, self.ny2), dtype=config_dtype())
        out = self._conv(ones, jnp.abs(self.kernel) ** alpha, [(0, 0), (0, 0)])
        return out.reshape(-1)
