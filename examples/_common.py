"""Shared helpers for the example scripts.

The reference examples load images from its images/ directory; these
examples ship committed procedural fixtures (``data/*.png``, generated by
data/make_fixtures.py) with the same roles, geometries and statistics as
the reference's eight test photos — lion/dog/flowers/fisch/house/maske2/
cow/junction_gray — and each example defaults to the SAME image role the
reference example loads (example_rof_primaldual.m:3 lion,
example_rof_dual.m:3 dog, example_tvl1.m:5 fisch, example_deblurring.m:3
flowers, example_tv_inpaint.m:5-6 lion+maske2,
example_multilabel_fast.m:3 junction_gray).  ``image="synthetic"`` keeps
the pure-synthetic piecewise-smooth pattern.  Every script accepts
--size / --cpu so the same code runs as a quick CPU demo or a full-size
run on the accelerator.
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "data")


def load_fixture_image(name="cow", size=None, gray=True):
    """Load a committed fixture image (data/<name>.png) as float in
    [0, 1], shape (ny, nx) when gray else (ny, nx, 3).  ``size`` resizes:
    an int means (size, size), a (ny, nx) tuple a rectangle.  Matches the
    role of the reference's imread('images/<name>.png')."""
    from prost_tpu.util.images import load_image

    if size is not None and np.isscalar(size):
        size = (size, size)
    return load_image(os.path.join(_DATA_DIR, f"{name}.png"), size, gray)


def fixture_or_synthetic(name, ny, nx, nc=1, seed=42):
    """The named fixture image resized to (ny, nx, nc), or the synthetic
    piecewise-smooth pattern when name == "synthetic" — examples default
    to the fixture playing the same role as the image the corresponding
    reference example loads."""
    if name == "synthetic":
        return synthetic_image(ny, nx, nc, seed)
    im = load_fixture_image(name, size=(ny, nx), gray=(nc == 1))
    if nc == 1:
        return im[..., None]
    if nc == 3:
        return im
    return np.repeat(im[..., None] if im.ndim == 2 else im[..., :1],
                     nc, axis=-1)


def synthetic_image(ny, nx, nc=1, seed=42):
    """Piecewise-smooth test image in [0, 1], shape (ny, nx, nc)."""
    x = np.linspace(0, 1, nx)
    y = np.linspace(0, 1, ny)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    base = (
        0.4 * (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.09)
        + 0.3 * (xx > 0.7)
        + 0.2 * np.sin(6 * np.pi * yy) * (xx < 0.25)
    )
    im = np.stack(
        [np.clip(base * (1 - 0.15 * c) + 0.05 * c, 0, 1) for c in range(nc)],
        axis=-1,
    )
    return im.astype(np.float64)


def flatten_image(im):
    """(ny, nx, nc) -> flat vector with MATLAB column-major layout
    (index = y + ny*x + nx*ny*c), matching the reference examples'
    `im(:)` and the gradient blocks' label_first=False contract."""
    return im.transpose(2, 1, 0).reshape(-1)


def unflatten_image(v, ny, nx, nc=1):
    return np.asarray(v).reshape(nc, nx, ny).transpose(2, 1, 0)


def setup_jax(cpu=False):
    """Select the CPU when asked and turn on the persistent compile cache
    (``prost_tpu.config.use_compile_cache``)."""
    import jax

    from prost_tpu.config import use_compile_cache

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache()


def add_std_args(ap, size=128):
    ap.add_argument("--size", type=int, default=size)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-iters", type=int, default=None)
    return ap


def tv_energy(grad_apply, u, n):
    """||grad u||_{2,1} for a 2-component gradient vector of length 2n."""
    import jax.numpy as jnp

    g = np.asarray(grad_apply(jnp.asarray(u)))
    return float(np.sum(np.sqrt(g[:n] ** 2 + g[n:] ** 2)))
