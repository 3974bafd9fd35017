"""Every file a cell needs is found by the names in BENCHMARK.json."""

import json
import os

import pytest

from lib import spec

SPEC = spec.load()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.Cell(SPEC, name)
    assert callable(cell.builder.build) and callable(cell.builder.answer)
    assert callable(cell.reference.reference)
    assert callable(cell.reference.numbers)
    assert {"image", "shape", "noise", "batch", "max_iters"} <= set(
        cell.traffic)
    assert cell.limits["limits"] and int(cell.limits["sample"]) >= 1
    assert {m["name"] for m in cell.per_layer + cell.end_to_end} == set(
        cell.readers)
    for reader in cell.readers.values():
        assert callable(reader.read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_runs(entry):
    with open(os.path.join(spec.ROOT, entry["file"])) as fh:
        cfg = json.load(fh)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


def test_every_metric_and_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert any(m["name"] in {p["name"] for p in spec.Cell(
            SPEC, c).per_layer} for c in CELLS), m["name"]


def test_new_entries_are_found_in_a_copy(tiny_root):
    """Cells, a mix and a metric added as files and entries only."""
    spec_copy = spec.load(tiny_root)
    cell = spec.Cell(spec_copy, "rof.tinybatch", tiny_root)
    assert cell.traffic["batch"] == 4 and cell.traffic["shape"] == [24, 32]
    assert {"requests_done", "iters_per_batch", "batch_step_us",
            "build_ms", "idle_share", "images_per_s", "setup_s"} == set(
        cell.readers)
    assert cell.builder.__file__.startswith(tiny_root)
