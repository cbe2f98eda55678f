"""Particle coordinates rasterized into masks (port of
topaz_tpu/ops/masks.py:20-70, the reference's topaz/utils/picks.py:16-50).

Ones are scattered at the particle centers and dilated by the integer disk
(or sphere); the reference convolves with a disk kernel and binarizes, which
gives the same mask. Host numpy: training rasterizes the test targets once
an epoch.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _disk_chords(radius: float):
    R = int(math.floor(radius))
    return [(dy, int(math.floor(math.sqrt(radius * radius - dy * dy))))
            for dy in range(-R, R + 1)]


def _dilate_rows(mask: np.ndarray, radius: float) -> np.ndarray:
    """Binary dilation of the last two axes by the integer disk."""
    H, W = mask.shape[-2:]
    out = np.zeros_like(mask)
    for dy, w in _disk_chords(radius):
        ys = slice(max(0, -dy), min(H, H - dy))
        yd = slice(max(0, dy), min(H, H + dy))
        rows = mask[..., ys, :]
        # horizontal dilation width 2w+1 via padded sliding-window any
        if w > 0:
            p = np.pad(rows, [(0, 0)] * (rows.ndim - 1) + [(w, w)])
            acc = np.zeros_like(rows, dtype=bool)
            for dx in range(2 * w + 1):
                acc |= p[..., dx:dx + W].astype(bool)
            rows = acc
        out[..., yd, :] |= rows.astype(bool)
    return out


def as_mask(shape: Tuple[int, ...], radius: float, x_coord, y_coord,
            z_coord=None) -> np.ndarray:
    """Float32 mask of all pixels within ``radius`` of any coordinate
    (topaz/utils/picks.py:16-50)."""
    mask = np.zeros(shape, dtype=bool)
    x = np.asarray(x_coord, dtype=int)
    y = np.asarray(y_coord, dtype=int)
    if z_coord is not None:
        z = np.asarray(z_coord, dtype=int)
        mask[z, y, x] = True
        R = int(math.floor(radius))
        out = np.zeros_like(mask)
        for dz in range(-R, R + 1):
            rem = radius * radius - dz * dz
            if rem < 0:
                continue
            zs = slice(max(0, -dz), min(shape[0], shape[0] - dz))
            zd = slice(max(0, dz), min(shape[0], shape[0] + dz))
            out[zd] |= _dilate_rows(mask[zs], math.sqrt(rem))
        return out.astype(np.float32)
    mask[y, x] = True
    return _dilate_rows(mask, radius).astype(np.float32)
