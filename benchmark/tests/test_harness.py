"""A run rehearsed on the CPU, with the look for a GPU stubbed out; and
the look itself, which refuses the CPU."""

import os
import subprocess
import sys

import pytest

from conftest import TINY, run_cell


@pytest.mark.parametrize("name", [t[0] for t in TINY])
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_run_prints_a_correct_result(tiny_root, on_cpu, capsys,
                                               name, trace):
    rc, out = run_cell(tiny_root, name, capsys, trace=trace)
    assert rc == 0 and out["correct"] is True
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    m = out["metrics"]
    if trace:
        assert m["requests_done"]["value"] >= 1 and "build_ms" in m
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert ("iters_per_batch" in m) == (name == "rof.tinybatch")
    else:
        assert m["images_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
        assert set(m) <= {"images_per_s", "setup_s", "solve_s_p90"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_measurement_refuses_the_cpu(tiny_root, capsys):
    rc, out = run_cell(tiny_root, "rof.tiny", capsys)
    assert rc == 2 and out is None


def test_exits_nonzero_with_only_the_benchmark(tiny_root, tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone has no
    program and no GPU: the run fails and prints no result."""
    import shutil

    shutil.copytree(os.path.join(tiny_root, "benchmark"),
                    tmp_path / "benchmark")
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rof.tiny",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout
