"""Reduction of a ``jax.profiler`` trace to the numbers the per-layer
metrics read.

``extract`` turns the profiler's ``.xplane.pb`` into a small plain record,

    {"device": [[start_ns, dur_ns, name, module], ...],
     "host":   [[start_ns, dur_ns, name], ...]}

with the kernels and copies that ran on the GPUs, and the harness's own
host spans (the ``TraceAnnotation`` names in ``SPANS``).  Every function
after it works on that record, so a test can feed it a recorded one.
"""

from __future__ import annotations

import glob
import os

SPANS = ("generate", "build", "solve", "fetch")


def _stat(ev, name):
    for k, v in ev.stats:
        if k == name:
            return str(v)
    return ""


def extract(trace_dir):
    """The plain record of the newest trace under ``trace_dir``."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    device, host = [], []
    for plane in pd.planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:  # one line per CUDA stream
                for ev in line.events:
                    device.append([int(ev.start_ns), int(ev.duration_ns),
                                   ev.name, _stat(ev, "hlo_module")])
        elif plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name in SPANS:
                        host.append([int(ev.start_ns), int(ev.duration_ns),
                                     ev.name])
    device.sort()
    host.sort()
    return {"device": device, "host": host}


def window(record):
    """(start, end) in ns of the traced stretch: the harness's spans from
    the first to the last."""
    spans = record["host"]
    if not spans:
        return 0, 0
    return spans[0][0], max(s + d for s, d, _ in spans)


def busy_intervals(events, t0, t1):
    """Union of the device events' intervals, clipped to [t0, t1]."""
    out = []
    for ev in sorted(events):
        s, e = max(ev[0], t0), min(ev[0] + ev[1], t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(record, module=None):
    """Nanoseconds in the traced stretch in which the device ran an
    operation (of ``module`` alone, when given)."""
    t0, t1 = window(record)
    evs = [e for e in record["device"] if module is None or e[3] == module]
    return sum(e - s for s, e in busy_intervals(evs, t0, t1))


def top_ops(record, n=10):
    """The ``n`` device operations that took most time: [[name, s], ...]."""
    t0, t1 = window(record)
    tot = {}
    for s, d, name, _ in record["device"]:
        if s >= t0 and s + d <= t1:
            tot[name] = tot.get(name, 0) + d
    top = sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    return [[name, ns / 1e9] for name, ns in top]


def _host_span_at(record, t):
    """The innermost harness span open on the host at time ``t``."""
    best = None
    for s, d, name in record["host"]:
        if s <= t < s + d and (best is None or d < best[0]):
            best = (d, name)
    return best[1] if best else "none"


def idle_gaps(record, n=10):
    """The ``n`` longest stretches with no device operation, each named by
    the harness span open on the host in its middle: [[name, s], ...]."""
    t0, t1 = window(record)
    busy = busy_intervals(record["device"], t0, t1)
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if t1 > prev:
        gaps.append((prev, t1))
    gaps.sort(key=lambda g: (g[0] - g[1], g[0]))
    return [[_host_span_at(record, (s + e) // 2), (e - s) / 1e9]
            for s, e in gaps[:n]]


# the programs of the two solve loops (lib/paths.py)
LOOP_MODULE = {False: "jit__pdhg_run", True: "jit__batched_pdhg_run"}


def loop_step_us(run):
    """Device-busy microseconds per trip of the solve loop in the traced
    stretch: the union of the intervals of the loop's program over the
    trips the traced requests ran (one PDHG iteration; on the batched path
    one iteration of every instance).  None when nothing was traced."""
    if run.trace is None or not run.traced:
        return None
    trips = sum(run.done[i].trips for i in run.traced)
    busy = busy_ns(run.trace, LOOP_MODULE[run.batch > 1])
    if trips <= 0 or busy <= 0:
        return None
    return busy / 1e3 / trips
