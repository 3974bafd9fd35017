"""idle_share: percent of the traced stretch in which no operation ran on
the device (1 - union of the device's busy intervals / stretch)."""

from lib import trace


def read(run):
    if run.trace is None or not run.trace["host"]:
        return None
    t0, t1 = trace.window(run.trace)
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.trace) / (t1 - t0))
