"""The traffic generator: requests are a pure function of (seed, index)."""

import numpy as np
import pytest

from lib.traffic import Traffic, resize

MIX = {"image": "lion", "shape": [24, 32], "noise": 0.05, "batch": 1,
       "flips": False, "max_iters": 100}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 4294967311, -3])
def test_same_seed_same_requests(seed):
    a, b = Traffic(MIX, seed), Traffic(MIX, seed)
    for i in (0, 1, 17):
        np.testing.assert_array_equal(a.request(i), b.request(i))
    assert not np.array_equal(a.request(0), a.request(1))


def test_seeds_differ_in_noise_not_in_sizes():
    a, b = Traffic(MIX, 1).request(0), Traffic(MIX, 2).request(0)
    assert a.shape == b.shape == (24, 32) and a.dtype == np.float32
    assert not np.array_equal(a, b)


def test_batch_with_flips_keeps_shape_and_is_deterministic():
    mix = {**MIX, "batch": 5, "flips": True}
    r = Traffic(mix, 3).request(2)
    assert r.shape == (5, 24, 32)
    np.testing.assert_array_equal(r, Traffic(mix, 3).request(2))


def test_noise_has_the_stated_spread():
    mix = {**MIX, "shape": [128, 128]}
    t = Traffic(mix, 11)
    assert abs(np.std(t.request(0) - t.clean) - 0.05) < 0.002


def test_resize_keeps_constants_and_range():
    img = np.full((10, 14), 0.25)
    out = resize(img, (33, 5))
    assert out.shape == (33, 5)
    np.testing.assert_allclose(out, 0.25)
