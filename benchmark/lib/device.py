"""The device a run measures on: refuses anything but enough GPUs, and
reads the card's name, power limit and peak memory."""

from __future__ import annotations

import subprocess


class NoAccelerator(RuntimeError):
    pass


def require_gpu(chips):
    """The device record {platform, kind, count}; raises NoAccelerator
    when JAX finds no GPU or fewer than ``chips`` of them (a measurement
    never falls back to the CPU)."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError as e:
        raise NoAccelerator(f"no GPU: {e}") from None
    if len(devs) < chips:
        raise NoAccelerator(f"{len(devs)} GPU(s), the cell needs {chips}")
    if jax.devices()[0].platform != "gpu":
        raise NoAccelerator("JAX's default device is not a GPU")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": chips}


def card():
    """Name and power limit of each card as nvidia-smi reports them (a
    card set below its maximum power runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def memory_peak(chips):
    """Peak bytes in use on the fullest of the first ``chips`` devices."""
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.devices()[:chips])
