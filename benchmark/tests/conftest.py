"""The benchmark's own tests run on the CPU at tiny sizes:

    JAX_PLATFORMS=cpu python -m pytest benchmark/tests -q

They rehearse a run on the CPU with the look for a GPU stubbed out, so
they say nothing about speed."""

import atexit
import json
import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# compiled CPU programs stay out of the checkout's cache
_CACHE = tempfile.mkdtemp(prefix="jaxc-")
os.environ["JAX_COMPILATION_CACHE_DIR"] = _CACHE
atexit.register(shutil.rmtree, _CACHE, True)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import pytest  # noqa: E402

# tiny cells added to a copy of the benchmark: (workload, config, traffic
# it is cut from, batch)
TINY = [("rof.tiny", "rof", "photo", 1),
        ("multilabel.tiny", "multilabel", "cow8", 1),
        ("rof.tinybatch", "rof", "bsds32", 4)]
TINY_SHAPE = [24, 32]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A copy of BENCHMARK.json and benchmark/ with the tiny cells, and a
    per-layer metric of the tests' own, added as files and entries only."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, config, base, batch in TINY:
        mix = name.split(".")[1]
        t = json.loads((root / "benchmark" / "traffic" / f"{base}.json")
                       .read_text())
        t.update(shape=TINY_SHAPE, batch=batch)
        (root / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(t))
        cell_base = {"rof": "rof.photo", "multilabel": "multilabel.cow8"}
        shutil.copy(root / "benchmark" / "limits" /
                    f"{cell_base[config]}.json",
                    root / "benchmark" / "limits" / f"{name}.json")
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": mix, "chips": 1,
                                  "why": "tiny CPU rehearsal"})
    (root / "benchmark" / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    spec["per_layer"].append({
        "name": "requests_done", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "tests", "moves": "images_per_s",
        "workloads": [t[0] for t in TINY]})
    for m in spec["per_layer"]:
        if m["name"] in ("iters_per_image", "iter_us"):
            m["workloads"] += ["rof.tiny", "multilabel.tiny"]
    spec["per_layer"] += [
        {"name": "iters_per_batch", "unit": "iters", "better": "lower",
         "source": "program_counter", "layer": "solver driver and stopping"
         " rule", "moves": "images_per_s", "workloads": ["rof.tinybatch"]},
        {"name": "batch_step_us", "unit": "us", "better": "lower",
         "source": "device_trace", "layer": "backend loop",
         "moves": "images_per_s", "workloads": ["rof.tinybatch"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return str(root)


@pytest.fixture
def on_cpu(monkeypatch):
    """Skip the harness's look for a GPU: the rest of a run goes on."""
    from lib import device, harness

    monkeypatch.setattr(device, "require_gpu", lambda chips: {
        "platform": "cpu", "kind": "cpu", "count": chips})
    monkeypatch.setattr(device, "memory_peak", lambda chips: 0)
    monkeypatch.setattr(harness, "peaks_for", lambda kind: {
        "hbm_bytes_per_s": 3.35e12})


def run_cell(root, workload, capsys, seconds=0.5, trace=0, seed=12345):
    """One run of ``workload`` from the checkout at ``root``: (exit code,
    result line or None)."""
    import time

    from lib import harness

    rc = harness.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      time.perf_counter(), root=root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
