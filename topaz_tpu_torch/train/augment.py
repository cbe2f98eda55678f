"""Crop augmentation on the device: random rotation, center crop and flips
(port of topaz_tpu/train/augment.py:24-105).

The reference augments each crop on the host with torchvision (nearest
rotation of a sqrt(2)-oversized crop, center crop, flips;
topaz/utils/data/memory_mapped_data.py:216-231). The 2D ``CropSampler``
already hands in crops augmented at the final size (its fused gather), so
the train step calls this only for a sampler that hands in raw oversized
crops. 3D crops (``--augment-3d``) rotate in the xy-plane about z, every
z-slice of a crop by that crop's angle, then flip along x, y and z: the
missing-wedge-safe group for single-axis-tilt tomograms (the reference
never augments 3D crops).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def rotate_nearest(crops: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W) crop of a (B, H, W) batch counter-clockwise by its
    angle (degrees) about its center, nearest neighbour, zero fill
    (torchvision's rotate; ``_rotate_nearest`` of the JAX package)."""
    B, H, W = crops.shape
    theta = angles_deg.to(torch.float32) * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=crops.device)[:, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=crops.device)[None, :] - cx
    # inverse rotation of the output coordinates into the input
    iy = torch.round(cos * yy + sin * xx + cy).to(torch.int64)
    ix = torch.round(-sin * yy + cos * xx + cx).to(torch.int64)
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    out = torch.gather(crops.reshape(B, H * W), 1, flat.reshape(B, H * W)).reshape(B, H, W)
    return torch.where(valid, out, 0.0)


def transform_crops(crops: torch.Tensor, out_size: int, angles: Optional[torch.Tensor],
                    hflip: Optional[torch.Tensor], vflip: Optional[torch.Tensor]) -> torch.Tensor:
    """Rotate by ``angles`` (degrees; None: no rotation), center-crop to
    ``out_size`` and flip where the boolean ``hflip``/``vflip`` are set
    (None: no flips)."""
    if angles is not None:
        crops = rotate_nearest(crops, angles)
    S = crops.shape[-1]
    if S != out_size:
        off = (S - out_size) // 2
        crops = crops[:, off:off + out_size, off:off + out_size]
    if hflip is not None:
        crops = torch.where(hflip[:, None, None], crops.flip(2), crops)
        crops = torch.where(vflip[:, None, None], crops.flip(1), crops)
    return crops


def augment_crops(crops: torch.Tensor, generator: torch.Generator, out_size: int,
                  rotate: bool = True, flip: bool = True) -> torch.Tensor:
    """Randomly rotate (if enabled), center-crop to ``out_size`` and
    randomly h/v-flip a (B, S, S) batch, the random numbers drawn from
    ``generator`` on the crops' device."""
    B = crops.shape[0]

    def uniform():
        return torch.rand(B, generator=generator, device=crops.device)

    angles = uniform() * 360.0 if rotate else None
    hflip = uniform() < 0.5 if flip else None
    vflip = uniform() < 0.5 if flip else None
    return transform_crops(crops, out_size, angles, hflip, vflip)


def transform_crops_3d(crops: torch.Tensor, out_size: int, angles: Optional[torch.Tensor],
                       hflip: Optional[torch.Tensor], vflip: Optional[torch.Tensor],
                       zflip: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, D, S, S) volumes: every z-slice rotated about z by its crop's
    angle (degrees; None: no rotation), center-cropped to ``out_size`` on
    each axis, and flipped along x, y and z where the boolean
    ``hflip``/``vflip``/``zflip`` are set (None: no flips)."""
    B, D, S = crops.shape[:3]
    if angles is not None:
        crops = rotate_nearest(crops.reshape(B * D, S, S),
                               angles.repeat_interleave(D)).reshape(B, D, S, S)
    if S != out_size:
        off = (S - out_size) // 2
        crops = crops[:, :, off:off + out_size, off:off + out_size]
    if D != out_size:
        offz = (D - out_size) // 2
        crops = crops[:, offz:offz + out_size]
    if hflip is not None:
        crops = torch.where(hflip[:, None, None, None], crops.flip(3), crops)
        crops = torch.where(vflip[:, None, None, None], crops.flip(2), crops)
        crops = torch.where(zflip[:, None, None, None], crops.flip(1), crops)
    return crops


def augment_crops_3d(crops: torch.Tensor, generator: torch.Generator, out_size: int,
                     rotate: bool = True, flip: bool = True) -> torch.Tensor:
    """``transform_crops_3d`` of a (B, D, S, S) batch with random angles
    (if ``rotate``) and random x/y/z flips (if ``flip``), drawn from
    ``generator`` on the crops' device."""
    B = crops.shape[0]

    def uniform():
        return torch.rand(B, generator=generator, device=crops.device)

    angles = uniform() * 360.0 if rotate else None
    hflip, vflip, zflip = ((uniform() < 0.5, uniform() < 0.5, uniform() < 0.5) if flip
                           else (None, None, None))
    return transform_crops_3d(crops, out_size, angles, hflip, vflip, zflip)
