"""Profiling & observability utilities.

The reference's observability surface is: per-call kernel timing hooks
(prox.cu:59-70, linearoperator.cu:177-194), verbose residual printing
(solver.cu:162-168), and a predicted GPU-memory report (gpu_mem_amount,
backend_pdhg.cu:503-511).  Equivalents here:

* ``trace(dir)``     — jax.profiler trace context; view in TensorBoard/xprof.
* ``timed(fn, ...)`` — compile-then-time a jitted callable, returns
  (result, milliseconds): the "timed single-op eval" debug path.
* ``memory_stats()`` — live device memory from the runtime (the reference
  *predicts* memory; we read the allocator).
* ``compiled_memory_analysis(fn, *args)`` — XLA's own memory analysis of a
  compiled function (the closest analog of gpu_mem_amount, but exact).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the context into ``log_dir``."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, warmup: int = 1, repeats: int = 5):
    """(result, avg milliseconds) for a jitted callable — mirrors the
    reference's 5-repeat timing hook (linearoperator.cu:177-194)."""
    import jax

    jitted = jax.jit(fn)
    out = None
    for _ in range(max(warmup, 1)):
        out = jitted(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = jitted(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / repeats * 1e3
    return out, ms


def memory_stats(device=None) -> dict:
    """Live allocator statistics for a device (bytes_in_use etc.)."""
    import jax

    device = device or jax.devices()[0]
    stats = device.memory_stats()
    return dict(stats) if stats else {}


def compiled_memory_analysis(fn, *args) -> dict:
    """XLA's memory analysis of jit(fn) lowered for ``args``: exact device
    memory the program needs (argument/output/temp/generated code sizes)."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    mem = compiled.memory_analysis()
    if mem is None:
        return {}
    return {
        "argument_size_in_bytes": mem.argument_size_in_bytes,
        "output_size_in_bytes": mem.output_size_in_bytes,
        "temp_size_in_bytes": mem.temp_size_in_bytes,
        "generated_code_size_in_bytes": mem.generated_code_size_in_bytes,
    }
