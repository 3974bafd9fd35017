"""Linear-operator layer (counterpart of
/root/reference/src/linop and include/prost/linop)."""

from .base import Block, DualLinearOperator, LinearOperator
from .blocks import (
    BlockDense,
    BlockDiags,
    BlockIdKron,
    BlockKronId,
    BlockSparse,
    BlockZero,
)
from .conv import BlockConv2D
from .gradient import BlockGradient2D, BlockGradient3D

__all__ = [
    "Block",
    "LinearOperator",
    "DualLinearOperator",
    "BlockSparse",
    "BlockDense",
    "BlockDiags",
    "BlockKronId",
    "BlockIdKron",
    "BlockZero",
    "BlockConv2D",
    "BlockGradient2D",
    "BlockGradient3D",
]
