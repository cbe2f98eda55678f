"""Crop augmentation on the device: random rotation, center crop and flips
(port of topaz_tpu/train/augment.py:24-67, 2D).

The reference augments each crop on the host with torchvision (nearest
rotation of a sqrt(2)-oversized crop, center crop, flips;
topaz/utils/data/memory_mapped_data.py:216-231). The 2D ``CropSampler``
already hands in crops augmented at the final size (its fused gather), so
the train step calls this only for a sampler that hands in raw oversized
crops. The 3D variant waits for the 3D picker (ROADMAP P12).
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
