"""Operation counts of the 3D U-Net's patch loop, from shapes alone.

A multiply-add counts as two operations. A tomogram's work is that of the
published patch grid (topaz/denoising/datasets.py: ceil(n / s) patches an
axis, each (s + 2p)^3 voxels through the network), whatever implements it.
"""

from __future__ import annotations

from typing import List, Sequence


def unet3d_flops_per_voxel(layers: List[dict]) -> float:
    """Operations a voxel that enters the network: each convolution's
    2 k^3 cin cout at the 8^-level of the input's voxels it runs on."""
    return sum(2.0 * l["k"] ** 3 * l["cin"] * l["cout"] / 8 ** l["level"] for l in layers)


def patch_grid(shape: Sequence[int], patch_size: int, padding: int):
    """(patches, voxels through the network) of one volume."""
    n = 1
    for extent in shape:
        n *= -(-int(extent) // patch_size)
    return n, n * (patch_size + 2 * padding) ** 3


def tomogram_flops(shape: Sequence[int], layers: List[dict], patch_size: int,
                   padding: int) -> float:
    return patch_grid(shape, patch_size, padding)[1] * unet3d_flops_per_voxel(layers)
