"""Test configuration.

Tests run on the CPU with 8 virtual devices (so the sharding tests have a
mesh), hermetic and fast.  The tests marked ``gpu`` need the card: they
skip here, and ``chip_smoke.py`` runs them on the GPU in a process of
their own (PROST_TESTS_ON_GPU=1), which keeps JAX's default platforms.
XLA_FLAGS must be set before the CPU backend initializes.
"""

import os

import pytest

ON_GPU = os.environ.get("PROST_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device.  Without one the test skips — or fails, when
    it runs as chip_smoke.py's card-only phase, which must not pass on a
    machine without a card."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        if ON_GPU:
            pytest.fail(f"PROST_TESTS_ON_GPU=1 but no GPU: {e}")
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles thousands of XLA CPU programs in one
    process; past a few thousand live executables the XLA CPU client has
    been seen to segfault inside backend_compile_and_load (with ample
    host RAM free — a bookkeeping limit, not OOM).  Clearing per module
    caps the live count; cross-module cache reuse is negligible
    (different modules compile different programs)."""
    yield
    jax.clear_caches()
