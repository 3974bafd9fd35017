"""The reduction from trace to metrics, on a recorded excerpt of a chip
trace (tests/data/trace_excerpt.json)."""

import json
import os
import types

import numpy as np
import pytest

from lib import spec, trace

DATA = os.path.join(os.path.dirname(__file__), "data", "trace_excerpt.json")


@pytest.fixture(scope="module")
def excerpt():
    with open(DATA) as fh:
        return json.load(fh)


def _busy_by_grid(record):
    """Busy nanoseconds by brute force: mark every covered nanosecond."""
    t0, t1 = trace.window(record)
    grid = np.zeros(t1 - t0, bool)
    for s, d, *_ in record["device"]:
        grid[max(s, t0) - t0:min(s + d, t1) - t0] = True
    return int(grid.sum()), grid


@pytest.mark.parametrize("part", ["build_to_solve", "loop"])
def test_idle_share_matches_brute_force(excerpt, part):
    rec = excerpt[part]
    busy, _ = _busy_by_grid(rec)
    assert trace.busy_ns(rec) == busy
    run = types.SimpleNamespace(trace=rec)
    reader = spec.load_module(os.path.join(spec.BENCH, "metrics",
                                           "idle_share.py"), "idle")
    t0, t1 = trace.window(rec)
    assert reader.read(run) == pytest.approx(100 * (1 - busy / (t1 - t0)))


def test_iter_us_is_loop_busy_time_per_iteration(excerpt):
    rec = excerpt["loop"]
    busy, _ = _busy_by_grid(rec)
    done = {0: types.SimpleNamespace(trips=excerpt["loop"]["iterations"],
                                     iters=[5])}
    run = types.SimpleNamespace(trace=rec, traced=[0], done=done, batch=1)
    reader = spec.load_module(os.path.join(spec.BENCH, "metrics",
                                           "iter_us.py"), "iter_us")
    assert reader.read(run) == pytest.approx(busy / 1e3 / 5)
    # the excerpt's five iterations took 68 us of device time each
    assert 60 < reader.read(run) < 75


def test_top_ops_are_ordered_by_time(excerpt):
    rec = excerpt["loop"]
    ops = trace.top_ops(rec)
    secs = [s for _, s in ops]
    assert secs == sorted(secs, reverse=True) and len(ops) <= 10
    total = {}
    for s, d, name, _ in rec["device"]:
        total[name] = total.get(name, 0) + d
    assert ops[0][0] == max(total, key=total.get)
    assert ops[0][1] == pytest.approx(max(total.values()) / 1e9)


def test_idle_gaps_are_longest_first_and_named_by_host_span(excerpt):
    rec = excerpt["build_to_solve"]
    gaps = trace.idle_gaps(rec)
    secs = [s for _, s in gaps]
    assert secs == sorted(secs, reverse=True)
    _, grid = _busy_by_grid(rec)
    # the longest run of idle nanoseconds, found by brute force
    idle = np.concatenate([[0], (~grid).astype(np.int8), [0]])
    edges = np.flatnonzero(np.diff(idle))
    runs = edges[1::2] - edges[::2]
    assert gaps[0][1] == pytest.approx(runs.max() / 1e9)
    start = rec["host"][1][0]  # the solve span opens after build closes
    assert {name for name, _ in gaps} <= {"build", "solve"}
    assert gaps[0][0] == "solve" and start > rec["host"][0][0]
