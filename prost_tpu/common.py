"""Small shared utilities (mirrors /root/reference/src/common.cu and
include/prost/common.hpp).

The reference's csr2csc conversion (common.cu:54-82) has no direct analog
here: sparse blocks keep both row-sorted and column-sorted COO copies, built
with numpy at problem-construction time (see prost_tpu/linop/sparse.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

# Every matrix product and contraction in the solver runs at full float32
# precision.  Without it a platform may run float32 products in a reduced
# mode (TF32 on NVIDIA tensor cores keeps ~3 decimal digits), far below the
# 1e-5..1e-7 tolerances the solver is used at.
HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a, b):
    """``a @ b`` at full precision of the operands' dtype."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum(subscripts, *operands):
    """``jnp.einsum`` at full precision of the operands' dtype."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)


def linspace(start: float, end: float, n: int) -> list[float]:
    """Evenly spaced schedule used for callback iterations.

    Mirrors prost::linspace (/root/reference/src/common.cu:32-46), which the
    solver uses to pick the iterations at which the intermediate-solution
    callback fires (/root/reference/src/solver.cu:130-135).
    """
    if n == 1:
        return [float(start)]
    step = (float(end) - float(start)) / (n - 1)
    return [float(start) + step * i for i in range(n)]


def static_field(**kwargs):
    """Dataclass field marked static for jax.tree_util.register_dataclass."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree.

    Fields whose metadata has ``static=True`` become aux data (hashable,
    trace-time constants); all other fields are children (arrays).
    """
    cls = dataclasses.dataclass(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls
