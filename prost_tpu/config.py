"""Global configuration for prost_tpu.

The reference (prost) instantiates its whole stack for float and double
(/root/reference/src/solver.cu:254-255) and builds the MEX bridge with
real=double (/root/reference/matlab/+prost/private/config.hpp:6-7).

The default here is float32 iterates, with float64 available on demand.  Use
``set_dtype(jnp.float64)`` together with ``jax.config.update("jax_enable_x64",
True)`` for bit-accurate parity checks against the reference.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

_DTYPE = jnp.float32


def set_dtype(dtype) -> None:
    """Set the global floating dtype used for solver state and operators."""
    global _DTYPE
    _DTYPE = jnp.dtype(dtype)


def dtype():
    """Current global floating dtype."""
    return _DTYPE


class ProstError(Exception):
    """Framework-level error (mirrors prost::Exception,
    /root/reference/include/prost/exception.hpp:29-41)."""


def list_devices():
    """Available accelerator devices (prost.list_gpus analog,
    prost.cpp:287-297)."""
    import jax

    return jax.devices()


def set_device(index: int) -> None:
    """Select the default device for subsequent computation
    (prost.set_gpu analog, prost.cpp:299-303)."""
    import jax

    jax.config.update("jax_default_device", jax.devices()[index])


def use_compile_cache() -> None:
    """Keep JAX's persistent compilation cache in ``<checkout>/.jax_cache``.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  The default path is fixed, so a later process on the
    same checkout finds what an earlier one compiled.  Call before the
    first compilation."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
