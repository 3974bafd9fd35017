"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

    configs/<config>.json     the configuration as it is run (its ``file``)
    configs/<config>.py       builds prost's modeling problem from an image
    reference/<config>.py     the plain float64 reference
    traffic/<traffic>.json    the mix's parameters (lib/traffic.py)
    limits/<workload>.json    what ``correct`` compares, and the limits
    metrics/<metric>.py       one reader per metric, end-to-end or per-layer

A new configuration, mix, cell or metric is new files and new entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric, workload, spec):
    """Whether ``workload`` reports ``metric``: the cells it lists, else
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" not in metric:  # an end-to-end metric with no list
        return True
    moves = [m for m in spec["end_to_end"] if m["name"] == metric["moves"]]
    return bool(moves) and _reports(moves[0], workload, spec)


class Cell:
    """One entry of ``workloads`` with everything found for it."""

    def __init__(self, spec, name, root=ROOT):
        bench = os.path.join(root, "benchmark")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        self.config_name = cfg_entry["name"]
        self.config = _json(os.path.join(root, cfg_entry["file"]))
        self.builder = load_module(
            os.path.join(bench, "configs", self.config_name + ".py"),
            "bench_config_" + self.config_name)
        self.reference = load_module(
            os.path.join(bench, "reference", self.config_name + ".py"),
            "bench_reference_" + self.config_name)
        self.traffic = _json(os.path.join(
            bench, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(bench, "limits", name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if _reports(m, name, spec)]
        self.per_layer = [m for m in spec["per_layer"]
                          if _reports(m, name, spec)]
        self.readers = {
            m["name"]: load_module(
                os.path.join(bench, "metrics", m["name"] + ".py"),
                "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.end_to_end + self.per_layer}
