"""The one traffic generator: turns a mix's parameter file
(``benchmark/traffic/<mix>.json``) and ``--seed`` into requests.

A mix's file holds:

    image      name of a grey image in ``benchmark/data/images.npz``
    shape      [rows, cols] of every request's image (resized when it
               differs from the stored image's)
    noise      standard deviation of the additive Gaussian noise
    batch      images per request (1: one image through ``pt.solve``;
               more: one batch through ``BatchedPDHG``)
    flips      whether each image of a request is flipped at random
               (shapes stay the same: square images flip only left-right
               and up-down)
    max_iters  the iteration cap of every solve

Request ``i`` of seed ``s`` is a pure function of (s, i): the same seed
gives the same requests, and every seed gives the same sizes.
"""

from __future__ import annotations

import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "images.npz")


def resize(img, shape):
    """Separable triangle-filter resize of an (H, W) float64 image: plain
    bilinear between pixel centres when enlarging, a widened triangle when
    shrinking."""
    out = np.asarray(img, np.float64)
    for axis, n_out in enumerate(shape):
        n_in = out.shape[axis]
        scale = n_in / n_out
        width = max(scale, 1.0)
        centre = (np.arange(n_out) + 0.5) * scale
        src = np.arange(n_in) + 0.5
        w = np.maximum(0.0, 1.0 - np.abs(src[None, :] - centre[:, None])
                       / width)
        w /= w.sum(axis=1, keepdims=True)
        out = np.moveaxis(np.tensordot(w, np.moveaxis(out, axis, 0), axes=1),
                          0, axis)
    return np.clip(out, 0.0, 1.0)


class Traffic:
    def __init__(self, params, seed):
        self.params = params
        self.seed = int(seed) % 2**64
        with np.load(DATA) as data:
            img = data[params["image"]].astype(np.float64) / 255.0
        shape = tuple(params["shape"])
        if img.shape != shape:
            img = resize(img, shape)
        self.clean = img.astype(np.float32)
        self.batch = int(params.get("batch", 1))
        self.shape = shape

    def request(self, i):
        """The noisy observations of request ``i``: (H, W) float32 when the
        mix's batch is 1, else (batch, H, W)."""
        p = self.params
        rng = np.random.default_rng([self.seed, int(i)])
        imgs = np.broadcast_to(self.clean, (self.batch,) + self.shape)
        if p.get("flips"):
            flips = rng.integers(0, 2, size=(self.batch, 2))
            imgs = np.stack([im[::1 - 2 * fx, ::1 - 2 * fy]
                             for im, (fx, fy) in zip(imgs, flips)])
        noise = rng.standard_normal(imgs.shape, dtype=np.float32)
        out = (imgs + np.float32(p["noise"]) * noise).astype(np.float32)
        return out[0] if self.batch == 1 else out
