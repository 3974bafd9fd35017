"""The comparison that decides ``correct``: it passes a correct solve,
fails one stopped early, and fails its bfloat16 control."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lib import spec
from lib.traffic import Traffic

SPEC = spec.load()
SHAPE = [24, 32]


def _cell(name):
    """The cell and a 64 x 96 crop of its first request, at the image's
    own resolution (a downscaled image is smoother, and the bfloat16
    control then reads closer to the program)."""
    cell = spec.Cell(SPEC, name)
    return cell, Traffic(cell.traffic, 99).request(0)[100:164, 200:296]


def _prost(cell, image, max_iters):
    from lib import paths

    call = paths.Single(cell.builder, cell.config)
    return call(image, max_iters, _nospan).answer


class _nospan:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _numbers(cell, image, answer, **kw):
    with jax.enable_x64(True):
        ref = cell.reference.reference(image, cell.config, **kw)
        return cell.reference.numbers(answer, image, cell.config, ref)


def _passes(cell, nums):
    return all(nums[k] <= v for k, v in cell.limits["limits"].items())


@pytest.mark.parametrize("name", ["rof.photo", "multilabel.cow8"])
def test_correct_solve_passes_and_early_stop_fails(name):
    cell, image = _cell(name)
    image = image[:32, :48]
    good = _numbers(cell, image, _prost(cell, image, 20000), rel_gap=1e-5)
    assert _passes(cell, good), good
    early = _numbers(cell, image, _prost(cell, image, 20), rel_gap=1e-5)
    assert not _passes(cell, early), early


@pytest.mark.parametrize("name", ["rof.photo", "multilabel.cow8"])
def test_bfloat16_control_fails(name):
    cell, image = _cell(name)
    with jax.enable_x64(True):
        ref = cell.reference.reference(image, cell.config, rel_gap=1e-5)
        ctl = cell.reference.reference(image, cell.config,
                                       dtype=jnp.bfloat16, max_iters=3000)
        nums = cell.reference.numbers(ctl["u"].astype(np.float32), image,
                                      cell.config, ref)
    assert not _passes(cell, nums), nums


def test_rof_reference_certifies_its_optimum():
    cell, image = _cell("rof.photo")
    image = image[:24, :32]
    with jax.enable_x64(True):
        ref = cell.reference.reference(image, cell.config)
        assert ref["rel_gap"] <= 1e-8
        # the reference's own answer sits within its certificate
        nums = cell.reference.numbers(ref["u"], image, cell.config, ref)
    assert 0 <= nums["excess"] <= 1e-8


def test_control_script_reports_failing_limits():
    import control

    cell = spec.Cell(SPEC, "rof.photo")
    cell.traffic = {**cell.traffic, "shape": SHAPE}
    worst = control.readings(cell, 5, requests=1, iters=2000)
    assert worst["excess"] > cell.limits["limits"]["excess"]
