"""Greedy non-maximum suppression in parallel rounds.

Port of topaz_tpu/ops/nms.py (2D). Per round, every still-active pixel that
is the strict maximum of its radius-r disk among active pixels is accepted,
then the disks of all accepted peaks are suppressed. The fixed point equals
the sequential greedy of the reference (topaz/algorithms.py:25-63); ties
inside a disk go to the larger linear index, matching
``np.argsort(A)[::-1]`` order.

Each round applies the disk max-filter three times. On the card that filter
is the CUDA kernel of ops/disk_max.py; ``disk_max`` here is its plain
version, used for tensors on the CPU and as the kernel's reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

NEG = float("-inf")
INT_NEG = -(2**31)


def _chords_2d(r: int):
    """(dy -> chord half-width) for the integer disk ii^2+jj^2 <= r^2,
    grouped by half-width: {w: [dy, ...]}."""
    groups = {}
    for dy in range(-r, r + 1):
        w = int(math.floor(math.sqrt(r * r - dy * dy)))
        groups.setdefault(w, []).append(dy)
    return groups


def disk_max(x: torch.Tensor, r: int, init=NEG) -> torch.Tensor:
    """Max filter over the clipped integer disk of radius r (last two axes
    spatial); taps outside the image read ``init``.

    Horizontal chord maxima build up incrementally over padded column
    shifts (the max over half-width w is the max over w-1 and the two taps
    at +-w); each chord row is then folded in by a padded row shift. Max is
    exact, so the result is bit-equal to any other order."""
    r = int(r)
    groups = _chords_2d(r)
    max_w = max(groups)
    H, W = x.shape[-2:]
    cols = x.new_full(x.shape[:-1] + (W + 2 * max_w,), init)
    cols[..., max_w:max_w + W] = x
    rows = x.new_full(x.shape[:-2] + (H + 2 * r, W), init)
    out = x.new_full(x.shape, init)
    cur = x
    for w in range(max_w + 1):
        if w > 0:
            left = cols[..., max_w - w:max_w - w + W]
            right = cols[..., max_w + w:max_w + w + W]
            cur = torch.maximum(cur, torch.maximum(left, right))
        if w not in groups:
            continue
        rows[..., r:r + H, :] = cur
        for dy in groups[w]:
            out = torch.maximum(out, rows[..., r + dy:r + dy + H, :])
    return out


def _greedy_rounds(score: torch.Tensor, threshold: float, max_filter) -> torch.Tensor:
    """Run parallel-greedy NMS rounds; returns the accepted-peak mask.
    Supports (H, W) and batched (..., H, W) inputs. The loop ends when no
    pixel is active, checked on the host once a round."""
    H, W = score.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32, device=score.device)
    lin = lin.reshape(H, W).expand(score.shape)
    neg = torch.tensor(NEG, dtype=score.dtype, device=score.device)
    int_neg = torch.tensor(INT_NEG, dtype=torch.int32, device=score.device)
    active = score > threshold
    accepted = torch.zeros_like(active)
    while bool(active.any()):
        masked = torch.where(active, score, neg).contiguous()
        dmax = max_filter(masked, NEG)
        is_max = active & (masked >= dmax)
        # tie-break toward larger linear index (argsort-descending order)
        cand_idx = torch.where(is_max, lin, int_neg).contiguous()
        imax = max_filter(cand_idx, INT_NEG)
        peaks = is_max & (lin >= imax)
        # suppress the disks of all accepted peaks
        dil = max_filter(peaks.to(torch.int32), INT_NEG) > 0
        active = active & ~dil
        accepted = accepted | peaks
    return accepted


def nms_mask_2d(score: torch.Tensor, r: int, threshold: float) -> torch.Tensor:
    """Accepted-peak mask for 2D greedy NMS of an (H, W) or (B, H, W) score
    map. On the card the disk max-filter is the CUDA kernel."""
    from topaz_tpu_torch.ops.disk_max import disk_max as disk_max_kernel

    return _greedy_rounds(score, threshold,
                          lambda x, init: disk_max_kernel(x, r, init))


def _mask_to_sorted(score: np.ndarray, mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: enumerate accepted peaks sorted by descending score with
    descending-index tie-break (reference emission order, algorithms.py:36)."""
    flat_idx = np.flatnonzero(mask.ravel())
    vals = score.ravel()[flat_idx]
    order = np.lexsort((-flat_idx, -vals))
    flat_idx = flat_idx[order]
    return vals[order].astype(np.float32), flat_idx


def non_maximum_suppression(
    x, r: int, threshold: float = -np.inf, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """2D NMS with the reference's interface: returns (scores, coords[x, y])
    sorted by descending score (topaz/algorithms.py:25-63). ``x`` is an
    (H, W) array or tensor; the rounds run on ``device``."""
    from topaz_tpu_torch.device import resolve_device

    x = torch.as_tensor(x, dtype=torch.float32, device=resolve_device(device))
    W = x.shape[1]
    mask = nms_mask_2d(x.contiguous(), int(r), float(threshold))
    scores, flat_idx = _mask_to_sorted(x.cpu().numpy(), mask.cpu().numpy())
    coords = np.stack([flat_idx % W, flat_idx // W], axis=1).astype(np.int32)
    return scores, coords
