"""Visualization: filter mosaics and iterate panels, written as PNG files
(torch port of ``ccsc_code_iccv2017_tpu.utils.display``, the
reference's display_func, 2D/admm_learn_conv2D_large_dParallel.m:326-369,
headless).

The JAX package draws them with matplotlib; the port writes the same
files (``filters_NNN.png``, ``iterates_NNN.png``) with a stdlib encoder
(zlib, struct): 8-bit grayscale, each image scaled to its own min..max
as ``imshow`` scales it, and the title in a ``tEXt`` chunk (``Title``)
rather than drawn on the figure. ``filter_mosaic`` is a copy.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence

import numpy as np


def filter_mosaic(d: np.ndarray, pad: int = 1) -> np.ndarray:
    """Tile support-domain filters [k, *extra, s1, s2] into one 2-D
    mosaic (takes the first slice of any extra dims, like the
    reference's inds{...}=10 slicing, dParallel.m:358-366)."""
    d = np.asarray(d)
    while d.ndim > 3:
        d = d[:, 0]
    k, s1, s2 = d.shape
    grid = int(math.ceil(math.sqrt(k)))
    out = np.zeros(
        (grid * (s1 + pad) + pad, grid * (s2 + pad) + pad), d.dtype
    )
    for j in range(k):
        r, c = divmod(j, grid)
        out[
            pad + r * (s1 + pad) : pad + r * (s1 + pad) + s1,
            pad + c * (s2 + pad) : pad + c * (s2 + pad) + s2,
        ] = d[j]
    return out


def _gray8(x: np.ndarray) -> np.ndarray:
    """A 2-D array scaled to 0..255 over its own min..max (a constant
    image is mid-gray; non-finite entries are black)."""
    x = np.asarray(x, np.float64)
    finite = np.isfinite(x)
    lo = x[finite].min() if finite.any() else 0.0
    hi = x[finite].max() if finite.any() else 0.0
    if hi > lo:
        y = (np.where(finite, x, lo) - lo) / (hi - lo) * 255.0
    else:
        y = np.full(x.shape, 127.0)
    return np.rint(y).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, title: str = "") -> None:
    """Write a uint8 2-D array as an 8-bit grayscale PNG, ``title`` in a
    ``tEXt`` chunk under the keyword ``Title``."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    png = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
    if title:
        png += _chunk(b"tEXt", b"Title\x00" + title.encode("latin-1",
                                                            "replace"))
    png += _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def save_filter_mosaic(path: str, d: np.ndarray, title: str = "") -> None:
    write_png(path, _gray8(filter_mosaic(d)), title)


def _to2d(x) -> np.ndarray:
    x = np.asarray(x)
    while x.ndim > 2:
        x = x[..., x.shape[-1] // 2] if x.shape[-1] < x.shape[0] else x[0]
    return x


def save_iterate_panel(
    path: str,
    originals: Sequence[np.ndarray],
    iterates: Sequence[np.ndarray],
    title: str = "",
    pad: int = 2,
) -> None:
    """Original vs current-iterate panels, one row per image (up to 3),
    original left and iterate right (the 3x2 grid of display_func,
    dParallel.m:333-352). 2-D slices are taken from higher-dimensional
    inputs, as the JAX package takes them."""
    n = min(len(originals), len(iterates), 3)
    tiles = [(_gray8(_to2d(originals[i])), _gray8(_to2d(iterates[i])))
             for i in range(n)]
    th = max(max(a.shape[0], b.shape[0]) for a, b in tiles)
    tw = max(max(a.shape[1], b.shape[1]) for a, b in tiles)
    out = np.zeros((n * (th + pad) + pad, 2 * (tw + pad) + pad), np.uint8)
    for i, pair in enumerate(tiles):
        for j, t in enumerate(pair):
            r, c = pad + i * (th + pad), pad + j * (tw + pad)
            out[r:r + t.shape[0], c:c + t.shape[1]] = t
    write_png(path, out, title)
