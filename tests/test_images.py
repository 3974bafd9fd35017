"""The numpy PNG reader and resize that load the committed fixtures
(prost_tpu/util/images.py)."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from prost_tpu.util.images import (load_image, read_png, resize_bilinear,
                                   to_gray, write_png)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
FIXTURES = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(DATA, "*.png")))


@pytest.mark.parametrize("name", FIXTURES)
def test_decoder_matches_pil(name):
    """Every committed fixture decodes to PIL's pixels, and its grey
    conversion to PIL's "L" mode."""
    Image = pytest.importorskip("PIL.Image")

    path = os.path.join(DATA, name)
    got = read_png(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im))
        if got.ndim == 3:
            np.testing.assert_array_equal(to_gray(got),
                                          np.asarray(im.convert("L")))


def _png_with_filter(img, kind):
    """Encode an (h, w, 3) uint8 image with PNG filter ``kind`` on every
    row (PNG spec section 9), so the decoder's inverse of each filter is
    exercised."""
    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_png_filter_decodes(kind, tmp_path):
    img = np.random.RandomState(kind).randint(0, 256, (7, 11, 3),
                                              dtype=np.uint8)
    path = tmp_path / f"f{kind}.png"
    path.write_bytes(_png_with_filter(img, kind))
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("shape", [(37, 23), (512, 300), (5, 900)])
def test_resize_keeps_shape_and_range(shape):
    img = np.random.RandomState(1).rand(64, 80)
    out = resize_bilinear(img, shape)
    assert out.shape == shape
    assert img.min() - 1e-12 <= out.min() and out.max() <= img.max() + 1e-12
    # a constant image stays constant at any size
    np.testing.assert_allclose(resize_bilinear(np.full((9, 4), 0.3), shape),
                               0.3)


def test_load_image_gray_and_rgb(tmp_path):
    rgb = np.random.RandomState(2).randint(0, 256, (6, 9, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    write_png(path, rgb)
    np.testing.assert_array_equal(read_png(path), rgb)
    g = load_image(path, (12, 18))
    c = load_image(path, (3, 4), gray=False)
    assert g.shape == (12, 18) and c.shape == (3, 4, 3)
    assert 0.0 <= g.min() and g.max() <= 1.0
