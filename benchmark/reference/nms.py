"""Greedy non-maximum suppression over the integer disk dy^2 + dx^2 <= r^2
(topaz/algorithms.py non_maximum_suppression), and the disk max filter it
rests on.

The greedy order is computed in parallel rounds: an active pixel that is
the largest in its disk among active pixels (ties to the larger linear
index, the order of ``np.argsort(scores)[::-1]``) is taken, then the disks
of everything taken are suppressed. The fixed point is the sequential
greedy pick set.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def disk_max(x: torch.Tensor, r: int) -> torch.Tensor:
    """Max of (B, H, W) float ``x`` over each pixel's disk of radius ``r``,
    clipped at the edges: one chord max a row offset (a max pool with -inf
    padding), shifted into place."""
    B, H, W = x.shape
    out = torch.full_like(x, -math.inf)
    for dy in range(-r, r + 1):
        w = math.isqrt(r * r - dy * dy)
        chord = F.max_pool2d(x[:, None], (1, 2 * w + 1), stride=1, padding=(0, w))[:, 0]
        if dy >= 0:
            out[:, : H - dy] = torch.maximum(out[:, : H - dy], chord[:, dy:])
        else:
            out[:, -dy:] = torch.maximum(out[:, -dy:], chord[:, : H + dy])
    return out


def greedy_nms(scores: torch.Tensor, r: int, threshold: float) -> torch.Tensor:
    """Mask of the greedy picks of (B, H, W) ``scores``: pixels above
    ``threshold``, each pick suppressing its disk."""
    B, H, W = scores.shape
    s = scores.double()
    lin = torch.arange(H * W, dtype=torch.float64, device=s.device).reshape(1, H, W).expand(B, H, W)
    active = s > threshold
    taken = torch.zeros_like(active)
    while bool(active.any()):
        masked = torch.where(active, s, -math.inf)
        is_max = active & (masked >= disk_max(masked, r))
        idx = torch.where(is_max, lin, -1.0)
        peaks = is_max & (lin >= disk_max(idx, r))
        active = active & ~(disk_max(peaks.double(), r) > 0)
        taken = taken | peaks
    return taken
