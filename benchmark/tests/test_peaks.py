"""The table of peaks and the byte count of the roofline agree with the
reckoning in PERF.md."""

import os

import pytest

from lib import harness, spec

roofline = spec.load_module(os.path.join(spec.BENCH, "metrics",
                                         "pdhg_iter_roofline.py"), "roof")


def test_h100_peaks():
    p = harness.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["fp32_flops_per_s"] == 67e12
    assert p["l2_bytes"] == 50e6


def test_unknown_device_is_an_error():
    with pytest.raises(KeyError):
        harness.peaks_for("NVIDIA A100-SXM4-80GB")


def test_rof_iteration_moves_64_bytes_a_pixel():
    assert roofline.iter_bytes((464, 700)) == 64 * 464 * 700
    assert roofline.iter_bytes((2048, 2048)) == 268_435_456
    assert roofline.iter_bytes((321, 481), batch=32) == 316_213_248


def test_roofline_share_from_time_per_iteration(monkeypatch):
    import types

    from lib import trace

    run = types.SimpleNamespace(shape=(2048, 2048), batch=1,
                                peaks={"hbm_bytes_per_s": 3.35e12})
    # 268 MB at 3.35 TB/s is 80.13 us: the whole roofline
    monkeypatch.setattr(trace, "loop_step_us", lambda r: 80.13)
    assert roofline.read(run) == pytest.approx(100.0, rel=1e-3)
    monkeypatch.setattr(trace, "loop_step_us", lambda r: 4 * 80.13)
    assert roofline.read(run) == pytest.approx(25.0, rel=1e-3)
