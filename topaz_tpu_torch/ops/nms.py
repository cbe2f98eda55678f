"""Greedy non-maximum suppression in parallel rounds.

Port of topaz_tpu/ops/nms.py (2D and 3D). Per round, every still-active
pixel that is the strict maximum of its radius-r disk (sphere, in 3D) among
active pixels is accepted, then the disks of all accepted peaks are
suppressed. The fixed point equals the sequential greedy of the reference
(topaz/algorithms.py:25-103); ties inside a disk go to the larger in-plane
linear index, matching ``np.argsort(A)[::-1]`` order in 2D and the JAX
package's rule in 3D.

Each round applies the max-filter three times. In 2D on the card that
filter is the CUDA kernel of ops/disk_max.py; ``disk_max`` here is its
plain version, used for tensors on the CPU and as the kernel's reference.
The 3D ``sphere_max`` was XLA ops on the TPU, not a Pallas kernel, and is
plain PyTorch on every device. The accepted peaks are gathered and sorted
on the score map's device; only they come back to the host.
``non_maximum_suppression`` records its rounds in an ``extract/nms`` stage
span and the peaks' way to the host in ``extract/fetch``,
``non_maximum_suppression_3d`` in ``extract3d/nms`` and
``extract3d/fetch``; the mask and table entry points (the batched
pipeline's among them) and the exact oracle record none.
``exact_non_maximum_suppression`` takes the peaks one at a time in the
literal greedy order, the rounds' oracle.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from topaz_tpu_torch.utils.profiling import stage

NEG = float("-inf")
INT_NEG = -(2**31)

# greedy rounds run in this process, and score maps that the
# ``non_maximum_suppression*`` entry points had to move to their device;
# callers may reset both to 0
rounds = 0
uploads = 0


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
    Supports (H, W), batched (..., H, W) and (D, H, W) inputs; the
    tie-break index is the in-plane one, ``arange(H * W)`` broadcast over
    the leading axes, in 3D too (topaz_tpu/ops/nms.py:133-134). The loop
    ends when no pixel is active, checked on the host once a round."""
    H, W = score.shape[-2:]
    lin = torch.arange(H * W, dtype=torch.int32, device=score.device)
    lin = lin.reshape(H, W).expand(score.shape)
    neg = torch.tensor(NEG, dtype=score.dtype, device=score.device)
    int_neg = torch.tensor(INT_NEG, dtype=torch.int32, device=score.device)
    global rounds
    active = score > threshold
    accepted = torch.zeros_like(active)
    while bool(active.any()):
        rounds += 1
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


def _topk_table(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Fixed-size table of the accepted peaks of (B, H, W) score maps:
    (vals (B, k), coords (B, k, 2) as (x, y), counts (B,)). Entries past
    ``count`` hold -inf / (-1, -1).

    Order is ``lax.top_k``'s: descending in the floats' total order (+0
    above -0), equal scores lower index first. ``torch.topk`` promises no
    tie order on the card and ``torch.sort`` holds -0 equal to +0, so the
    table comes from a stable descending sort of integer keys that order as
    the floats' total order does."""
    B, H, W = scores.shape
    flat = torch.where(mask, scores, torch.tensor(NEG, dtype=torch.float32,
                                                  device=scores.device)).reshape(B, -1)
    bits = flat.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :k]
    vals = flat.gather(-1, idx)
    valid = vals > NEG
    minus_one = torch.full_like(idx, -1)
    xs = torch.where(valid, idx % W, minus_one)
    ys = torch.where(valid, idx // W, minus_one)
    coords = torch.stack([xs, ys], dim=-1).to(torch.int32)
    return vals, coords, mask.sum(dim=(-2, -1), dtype=torch.int32)


def nms_topk_2d(score: torch.Tensor, r: int, threshold: float, k: int):
    """Greedy NMS of one (H, W) score map, kept on the device:
    (vals (k,), coords (k, 2) as (x, y), count) in ``lax.top_k`` order
    (topaz_tpu/ops/nms.py:227-244). Entries past ``count`` hold -inf and
    (-1, -1). ``k`` must not exceed H * W."""
    mask = nms_mask_2d(score.contiguous(), r, threshold)
    vals, coords, counts = _topk_table(score[None], mask[None], k)
    return vals[0], coords[0], counts[0]


def nms_topk_batched(scores: torch.Tensor, r: int, threshold: float, k: int):
    """Greedy NMS of a (B, H, W) batch of score maps, kept on the device:
    (vals (B, k), coords (B, k, 2) as (x, y), counts (B,))
    (topaz_tpu/ops/nms.py:247-265). The rounds run on the whole batch, so
    on the card each round is three launches of the disk-max kernel at
    (B, H, W); a map with no pixel above ``threshold`` (a dead frame, all
    -inf) takes no part in any round."""
    mask = nms_mask_2d(scores.contiguous(), r, threshold)
    return _topk_table(scores, mask, k)


def _sorted_peaks(score: torch.Tensor, mask: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(scores float32, flat indices) of the accepted peaks, by descending
    score and, among equal scores, descending index (the reference's
    emission order, algorithms.py:36). Gathered and sorted on the map's
    device; only the peaks come to the host."""
    idx = torch.nonzero(mask.reshape(-1)).reshape(-1).flip(0)
    vals = score.reshape(-1)[idx]
    order = torch.sort(vals, descending=True, stable=True).indices
    return vals[order].cpu().numpy(), idx[order].cpu().numpy()


def _score_map(x, device) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor on ``device``; counts an upload
    when it was not already there."""
    from topaz_tpu_torch.device import resolve_device

    global uploads
    device = resolve_device(device)
    there = (isinstance(x, torch.Tensor) and x.dtype == torch.float32
             and x.device.type == device.type
             and device.index in (None, x.device.index))
    if not there:
        uploads += 1
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.contiguous()


def non_maximum_suppression(
    x, r: int, threshold: float = -np.inf, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """2D NMS with the reference's interface: returns (scores, coords[x, y])
    sorted by descending score (topaz/algorithms.py:25-63). ``x`` is an
    (H, W) array or tensor; the rounds run on ``device``, and a map already
    there is not copied. The rounds run in an ``extract/nms`` stage span,
    the sorted peaks come to the host in ``extract/fetch``."""
    x = _score_map(x, device)
    W = x.shape[1]
    with stage("extract/nms", device=x.device):
        mask = nms_mask_2d(x, int(r), float(threshold))
    with stage("extract/fetch"):
        scores, flat_idx = _sorted_peaks(x, mask)
    coords = np.stack([flat_idx % W, flat_idx // W], axis=1).astype(np.int32)
    return scores, coords


def exact_non_maximum_suppression(
    x, r: int, threshold: float = -np.inf, max_peaks: Optional[int] = None, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """NMS in the literal greedy order (topaz_tpu/ops/nms.py:268-326): take
    the largest active score (the larger index on a tie), stop when it is
    not above ``threshold``, suppress its disk, repeat, at most
    ``max_peaks`` times (default: a packing bound that never truncates).
    A plain loop of tensor ops on ``device`` with one host check a peak; it
    launches no kernel, so it is the oracle for ``non_maximum_suppression``'s
    parallel rounds. Returns (scores, coords[x, y]) in greedy order."""
    x = _score_map(x, device)
    H, W = x.shape
    r = int(r)
    if max_peaks is None:
        max_peaks = int((H + r) * (W + r) / max(np.pi * (r / 2) ** 2, 1)) + 8
        max_peaks = min(max_peaks, H * W)
    flat = x.reshape(-1)
    N = flat.numel()
    lin = torch.arange(N, device=x.device)
    yy, xx = lin // W, lin % W
    neg = torch.tensor(NEG, dtype=flat.dtype, device=flat.device)
    active = flat > threshold
    picked = []
    while len(picked) < max_peaks:
        masked = torch.where(active, flat, neg)
        i = N - 1 - torch.argmax(masked.flip(0))
        if not bool(masked[i] > threshold):
            break
        picked.append(i)
        active &= (yy - yy[i]) ** 2 + (xx - xx[i]) ** 2 > r * r
    if not picked:
        return np.zeros(0, np.float32), np.zeros((0, 2), np.int32)
    idx = torch.stack(picked)
    scores = flat[idx].cpu().numpy()
    coords = torch.stack([xx[idx], yy[idx]], dim=1).to(torch.int32).cpu().numpy()
    return scores, coords


def _sphere_chords(r: float):
    """{half-width: [(dz, dy), ...]} for the integer sphere
    dz^2 + dy^2 + dx^2 <= r^2 (topaz_tpu/ops/nms.py:89-100)."""
    R = int(math.ceil(r))
    groups = {}
    for dz in range(-R, R + 1):
        for dy in range(-R, R + 1):
            m = r * r - dz * dz - dy * dy
            if m < 0:
                continue
            groups.setdefault(int(math.floor(math.sqrt(m))), []).append((dz, dy))
    return groups


def sphere_max(x: torch.Tensor, r: float, init=NEG) -> torch.Tensor:
    """Max filter over the clipped integer sphere of radius r over the last
    three axes (topaz_tpu/ops/nms.py:103-124); taps outside read ``init``.
    Chord maxima build up over column shifts as in ``disk_max``; each
    (dz, dy) chord is folded in by a padded plane-and-row shift. Max is
    exact, so the result is bit-equal to any other order."""
    groups = _sphere_chords(float(r))
    R = int(math.ceil(r))
    max_w = max(groups)
    D, H, W = x.shape[-3:]
    cols = x.new_full(x.shape[:-1] + (W + 2 * max_w,), init)
    cols[..., max_w:max_w + W] = x
    planes = x.new_full(x.shape[:-3] + (D + 2 * R, H + 2 * R, W), init)
    out = x.new_full(x.shape, init)
    cur = x
    for w in range(max_w + 1):
        if w > 0:
            left = cols[..., max_w - w:max_w - w + W]
            right = cols[..., max_w + w:max_w + w + W]
            cur = torch.maximum(cur, torch.maximum(left, right))
        if w not in groups:
            continue
        planes[..., R:R + D, R:R + H, :] = cur
        for dz, dy in groups[w]:
            torch.maximum(out, planes[..., R + dz:R + dz + D, R + dy:R + dy + H, :], out=out)
    return out


def nms_mask_3d(score: torch.Tensor, r: float, threshold: float) -> torch.Tensor:
    """Accepted-peak mask for 3D greedy NMS of a (D, H, W) score map
    (topaz_tpu/ops/nms.py:183-186), plain PyTorch on every device."""
    return _greedy_rounds(score, threshold, lambda x, init: sphere_max(x, r, init))


def non_maximum_suppression_3d(
    x, r: int, scale: float = 1.0, threshold: float = -np.inf, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """3D NMS (topaz_tpu/ops/nms.py:211-226, topaz/algorithms.py:66-103):
    the radius is ``scale * r``; returns (scores, coords[x, y, z]) sorted by
    descending score. The rounds run on ``device``, in an ``extract3d/nms``
    stage span, and the sorted peaks come to the host in ``extract3d/fetch``."""
    x = _score_map(x, device)
    D, H, W = x.shape
    with stage("extract3d/nms", device=x.device):
        mask = nms_mask_3d(x, float(scale * r), float(threshold))
    with stage("extract3d/fetch"):
        scores, flat_idx = _sorted_peaks(x, mask)
    rem = flat_idx % (H * W)
    coords = np.stack([rem % W, rem // W, flat_idx // (H * W)], axis=1).astype(np.int32)
    return scores, coords
