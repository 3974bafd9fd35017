"""Image fixtures without an imaging library: an 8-bit PNG decoder and
encoder and a bilinear resize, in numpy.

The examples and the benchmark read the committed fixture images
(``data/*.png``); this module is all they need for it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples/pixel


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8-bit grey, grey+alpha, RGB or RGBA PNG.
    Returns uint8 of shape (h, w) for grey, else (h, w, channels)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, body, crc
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"{path}: only non-interlaced 8-bit grey/RGB(A) PNGs are "
            f"supported (depth {depth}, colour type {color}, "
            f"interlace {interlace})")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = prev = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _unfilter(kind, line, prev, bpp):
    """Undo one scanline's PNG filter (PNG spec section 9)."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: running sum along the row, per channel
        return (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                % 256).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0  # Paeth
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """Encode an (h, w) grey or (h, w, 3) RGB uint8 image as a PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)  # filter type 0 on every row

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    with open(path, "wb") as fh:
        fh.write(_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                 + chunk(b"IEND", b""))


def to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma of an (h, w, 3|4) uint8 image, rounded the way
    common imaging libraries round it (fixed-point 16.16)."""
    rgb = img[..., :3].astype(np.int64)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


def resize_bilinear(img: np.ndarray, shape) -> np.ndarray:
    """Resize the first two axes of ``img`` to ``shape`` = (rows, cols)
    with the separable bilinear (triangle) filter: plain bilinear
    interpolation between pixel centres when enlarging; when shrinking,
    the triangle widens by the shrink factor so every input pixel
    contributes (no aliasing) — the common imaging-library convention."""
    out = np.asarray(img, np.float64)
    for axis, n_out in enumerate(shape):
        out = np.moveaxis(
            np.tensordot(_triangle_weights(out.shape[axis], n_out),
                         np.moveaxis(out, axis, 0), axes=1), 0, axis)
    return out


def _triangle_weights(n_in, n_out):
    """(n_out, n_in) row-normalized triangle-filter resampling matrix."""
    scale = n_in / n_out
    width = max(scale, 1.0)  # filter support in input pixels
    centre = (np.arange(n_out) + 0.5) * scale
    src = np.arange(n_in) + 0.5
    w = np.maximum(0.0, 1.0 - np.abs(src[None, :] - centre[:, None]) / width)
    return w / w.sum(axis=1, keepdims=True)


def load_image(path, shape=None, gray=True) -> np.ndarray:
    """A PNG as float64 in [0, 1]: (rows, cols) when gray, else
    (rows, cols, 3); resized to ``shape`` = (rows, cols) when given."""
    img = read_png(path)
    if img.ndim == 2:
        img = img if gray else np.repeat(img[..., None], 3, axis=-1)
    elif gray:
        img = to_gray(img)
    else:
        img = img[..., :3]
    out = img.astype(np.float64) / 255.0
    if shape is not None:
        out = np.clip(resize_bilinear(out, tuple(shape)), 0.0, 1.0)
    return out
