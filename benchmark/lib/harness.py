"""One run of one cell: set up, warm up, measure a closed loop for
``--seconds``, check the answers against the plain reference, print.

The client is one closed loop: it sends request i + 1 when request i has
returned.  A request's time runs from the observation array on the host to
the answer on the host.  The request that straddles the end of the window
is finished and counted.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import types

import numpy as np

from lib import device, spec, trace, traffic as traffic_mod
from lib import paths as paths_mod

WARM_ITERS = 30     # the capped warm-up solve; ``until`` is traced, so
                    # this compiles the program every full solve runs
TRACE_AFTER = 1 / 3  # the traced stretch starts this far into the window
TRACE_SECONDS = 0.5  # ... and takes whole requests until this much passed


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def configure_jax():
    """The persistent compilation cache at a fixed path in the checkout,
    unless JAX_COMPILATION_CACHE_DIR names one; every compile is cached."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(spec.ROOT, ".bench_cache", "jax"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


class Compiles:
    """Counts XLA backend compiles (and their seconds) and hits of the
    persistent compilation cache."""

    def __init__(self):
        import jax

        self.count, self.seconds, self.hits = 0, 0.0, 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, event, duration, **kw):
        if "backend_compile" in event:
            self.count += 1
            self.seconds += duration

    def _event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def since(self, mark):
        return (self.count - mark[0], self.seconds - mark[1],
                self.hits - mark[2])

    def mark(self):
        return (self.count, self.seconds, self.hits)


class Spans:
    """Host spans around the calls into each layer: durations always,
    ``TraceAnnotation``s in the profiler's trace while ``tracing``."""

    def __init__(self):
        self.tracing = False
        self.last = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import jax

        ann = (jax.profiler.TraceAnnotation(name) if self.tracing
               else contextlib.nullcontext())
        t = time.perf_counter()
        with ann:
            yield
        self.last[name] = time.perf_counter() - t


def sample(done, seed, k):
    """Requests to check: the one with most iterations, and k - 1 more
    drawn from the seed."""
    idx = sorted(done)
    longest = max(idx, key=lambda i: (max(done[i].iters), -i))
    rest = [i for i in idx if i != longest]
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[j] for j in pick)


def check(cell, gen, done, seed):
    """Compare the sampled answers with the plain reference in float64.
    Returns ({number: worst value}, info lines)."""
    import jax

    lim = cell.limits
    worst, info = {}, []
    with jax.enable_x64(True):
        for i in sample(done, seed, int(lim["sample"])):
            images = gen.request(i)
            t = time.perf_counter()
            ref = cell.reference.reference(images, cell.config)
            nums = cell.reference.numbers(done[i].answer, images,
                                          cell.config, ref)
            info.append(f"reference request {i}: {ref['iters']} iterations,"
                        f" gap {ref['rel_gap']:.3e},"
                        f" {time.perf_counter() - t:.2f} s, {nums}")
            for k, v in nums.items():
                worst[k] = max(worst.get(k, -np.inf), v)
    return worst, info


def measure(cell, args, t_start):
    """The whole run; returns the result line's object."""
    import jax

    configure_jax()
    dev = device.require_gpu(cell.chips)
    log(f"card: {device.card()}")
    import prost_tpu  # noqa: F401  (the system under test)

    compiles = Compiles()
    gen = traffic_mod.Traffic(cell.traffic, args.seed)
    call = paths_mod.for_traffic(cell.traffic, cell.builder, cell.config)
    spans = Spans()
    cap = int(cell.traffic["max_iters"])

    t_warm = time.perf_counter()
    call(gen.request(0), WARM_ITERS, spans)
    setup_s = time.perf_counter() - t_start
    n, secs, hits = compiles.mark()
    log(f"setup: {t_warm - t_start:.3f} s to the warm-up, warm-up"
        f" {setup_s - (t_warm - t_start):.3f} s; {n} programs built"
        f" ({secs:.3f} s), {hits} of them from the persistent cache"
        f" {jax.config.jax_compilation_cache_dir}")

    trace_dir = None
    if args.trace:
        os.makedirs(os.path.join(spec.ROOT, ".bench_cache"), exist_ok=True)
        trace_dir = tempfile.mkdtemp(prefix="trace-", dir=os.path.join(
            spec.ROOT, ".bench_cache"))
    done, recs, raised = {}, [], 0
    traced, tracing_until = [], None
    mark = compiles.mark()
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        if now >= args.seconds:
            break
        if args.trace and tracing_until is None and (
                now >= TRACE_AFTER * args.seconds):
            jax.profiler.start_trace(trace_dir, profiler_options=_options())
            spans.tracing, tracing_until = True, now + TRACE_SECONDS
        with spans("generate"):
            images = gen.request(i)
        ts = time.perf_counter()
        try:
            d = call(images, cap, spans)
        except Exception:  # a request that raised has failed; go on
            log(f"request {i} raised:\n{traceback.format_exc()}")
            raised += gen.batch
            i += 1
            continue
        te = time.perf_counter()
        done[i] = d
        recs.append({"i": i, "start": ts - t0, "end": te - t0,
                     "traced": spans.tracing, **{
                         k + "_s": spans.last[k]
                         for k in ("build", "solve", "fetch")}})
        if spans.tracing:
            traced.append(i)
            if te - t0 >= tracing_until:
                jax.profiler.stop_trace()
                spans.tracing = False
        i += 1
    if spans.tracing:
        jax.profiler.stop_trace()
        spans.tracing = False
    in_window = compiles.since(mark)[0]
    elapsed = max(r["end"] for r in recs) if recs else args.seconds

    mem = device.memory_peak(cell.chips)
    images = sum(d.images for d in done.values())
    conv = sum(d.converged for d in done.values())
    lat = [r["end"] - r["start"] for r in recs]
    log(f"window: {len(recs)} requests, {images} images in {elapsed:.4f} s;"
        f" {conv} converged, {raised} raised; compiles in window:"
        f" {in_window}")
    log(f"peak device memory: {mem} bytes; setup {setup_s:.3f} s")
    if lat:
        log(f"request seconds: median {np.median(lat):.5f},"
            f" p90 {np.percentile(lat, 90):.5f}, max {max(lat):.5f}")

    # what every metric reader gets (benchmark/metrics/<name>.py: read(run))
    run = types.SimpleNamespace(
        requests=recs, done=done, batch=gen.batch, shape=gen.shape,
        setup_s=setup_s, traced=traced, trace=None, config=cell.config,
        traffic=cell.traffic, peaks=None, device=dev)
    if args.trace:
        run.trace = trace.extract(trace_dir)
        shutil.rmtree(trace_dir, ignore_errors=True)
        run.peaks = peaks_for(dev["kind"])

    gc.collect()
    if done:
        worst, info = check(cell, gen, done, args.seed)
    else:
        worst, info = {}, ["no request finished"]
    for line in info:
        log(line)
    checks = {k: {"value": worst.get(k), "limit": v}
              for k, v in cell.limits["limits"].items()}
    correct = bool(done) and raised == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    out = {"correct": correct, "attempted": images + raised,
           "failed": images - conv + raised, "metrics": {}}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = cell.readers[m["name"]].read(run)
        if v is not None:  # a reader that finds nothing is left out
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    out["device"] = {**dev, "memory_peak_bytes": mem}
    if args.trace:
        t0n, t1n = trace.window(run.trace)
        out["device"].update(busy_s=trace.busy_ns(run.trace) / 1e9,
                             window_s=(t1n - t0n) / 1e9)
        out["breakdown"] = {"device_ops": trace.top_ops(run.trace),
                            "idle_gaps": trace.idle_gaps(run.trace)}
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']} limit {c['limit']}")
    return out


def _options():
    """Device and host events without the Python function tracer, which
    would slow every host call in the traced stretch."""
    import jax

    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.host_tracer_level = 1
    return opts


def peaks_for(kind):
    """The published peaks of ``kind``; an unknown device is an error."""
    with open(os.path.join(spec.BENCH, "peaks.json")) as fh:
        table = json.load(fh)["devices"]
    if kind not in table:
        raise KeyError(f"no published peaks for device {kind!r} in "
                       "benchmark/peaks.json")
    return table[kind]


def main(argv, t_start, root=spec.ROOT):
    args = parse(argv)
    cell = spec.Cell(spec.load(root), args.workload, root)
    try:
        out = measure(cell, args, t_start)
    except device.NoAccelerator as e:
        log(f"refusing to measure: {e}")
        return 2
    print(json.dumps(out), flush=True)
    return 0
