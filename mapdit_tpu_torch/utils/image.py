"""Image grids, port of ``mapdit_tpu/utils/image.py``: an (N, C, H, W) float
batch to a PNG grid with value-range normalisation. The PNG is written with
``zlib`` and ``struct`` from the standard library (8-bit grey, grey with
alpha, RGB or RGBA, no filter), so no imaging package is needed."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(samples: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    """(N, C, H, W) floats -> (N, H, W, C) uint8, clamped and rescaled."""
    lo, hi = value_range
    x = np.clip(np.nan_to_num(samples), lo, hi)
    x = (x - lo) / (hi - lo)
    x = (x * 255.0).round().astype(np.uint8)
    return np.transpose(x, (0, 2, 3, 1))


def encode_png(image: np.ndarray) -> bytes:
    """A PNG file's bytes for an (H, W) or (H, W, C) uint8 array, C = 1, 2
    (grey with alpha), 3 (RGB) or 4 (RGBA), as PIL reads such an array."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[1 if image.ndim == 2 else image.shape[2]]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter type 0 a row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def save_image_grid(samples: np.ndarray, path, nrow: int = 8, value_range=(-1.0, 1.0), padding: int = 2) -> None:
    """Save an (N, C, H, W) batch as a grid PNG with ``nrow`` images a row,
    ``padding`` black pixels between and around them. ``path`` is a file
    path or a writable binary file object."""
    imgs = to_uint8(np.asarray(samples), value_range)
    n, h, w, c = imgs.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * (h + padding) + padding, nrow * (w + padding) + padding, c), dtype=np.uint8)
    for i, img in enumerate(imgs):
        r, col = divmod(i, nrow)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = img
    if c == 1:
        grid = grid[..., 0]
    data = encode_png(grid)
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
