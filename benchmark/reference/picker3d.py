"""Topaz's 3D ResNet8 particle picker, dense over a whole tomogram, its
operation count, and the judge of a tomogram's picks, in plain
``torch.nn.functional``.

The model is ``ResNet8`` with ``dims=3`` (tbepler/topaz
topaz/model/features/resnet.py:280-306): a 7^3 convolution (stride 2), a
residual block (dilation 2), a residual block (stride 2, a 1x1x1
projection where the width grows), a residual block (dilation 2), a 5^3
convolution, ReLU after each, and the 1x1x1 classifier of
topaz/model/classifier.py. A residual block is conv0 3^3 -> ReLU -> conv1
3^3 (its dilation and stride) added to the input cropped by both
convolutions' reach (and projected), then ReLU. With batch norm (``topaz
train``'s default, ``--bn on``) the convolutions have no bias, and an
eval-mode batch norm with the running statistics follows each
convolution before its ReLU, in a residual block conv0 and the sum. Dense ("filled") scoring
runs every stride as 1 and multiplies the dilation of the layers after it
(resnet.py fill(), :227-238), on the tomogram zero-padded by half the
receptive field, so the map has the tomogram's shape.

Written from that description, with these departures:

* Weights come from a seeded ``.npz`` in the JAX layout (kernels DHWIO,
  keys ``params:features.<i>.<name>`` and ``params:classifier.w``/``b``,
  batch norm's scale and bias under ``params:features.<i>.<bn>.`` and its
  running mean and variance under ``state:features.<i>.<bn>.``), turned
  into OIDHW here; the published model loads a pickled ``.sav``.
* The map is computed in z-slabs of ``slab`` output planes, each from its
  own window of the padded tomogram (the slab and the receptive field's
  reach on either side), so that one card holds every activation. That is
  the same map in another blocking than the program's 96^3 tiles
  (topaz/model/classifier.py:69-103 ``classify_patches``).
* Float32 with TF32 off unless a caller asks for it (the control).

``pick_gap_3d`` judges picks against this map as ``harness/check.pick_gap``
does in 2D, over the integer sphere dz^2 + dy^2 + dx^2 <= r^2 of
topaz/algorithms.py:66-103.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import receptive_field

# what a structural fault reads (as harness/check.FAULT): no rounding comes
# near it, and it stays a number in the result line
FAULT = 1e9


def load_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """``{"features.<i>.<name>" | "classifier.<w|b>": tensor}`` of an
    ``.npz`` checkpoint's parameters and batch-norm statistics, kernels
    turned from DHWIO to OIDHW, float32 on ``device``."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            tree, _, name = key.partition(":")
            if tree not in ("params", "state"):
                continue
            a = np.asarray(z[key], dtype=np.float32)
            if a.ndim == 5:
                a = a.transpose(4, 3, 0, 1, 2)
            out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def layers(units: int) -> List[dict]:
    """ResNet8's layer list at ``units`` (widths units, 2 units, 4 units),
    each convolution with its kernel, channels, stride and dilation."""
    u = [units, 2 * units, 4 * units]
    return [{"op": "conv", "k": 7, "cin": 1, "cout": u[0], "stride": 2, "dilation": 1},
            {"op": "resid", "cin": u[0], "hidden": u[0], "cout": u[0], "stride": 1,
             "dilation": 2},
            {"op": "resid", "cin": u[0], "hidden": u[0], "cout": u[1], "stride": 2,
             "dilation": 2},
            {"op": "resid", "cin": u[1], "hidden": u[1], "cout": u[1], "stride": 1,
             "dilation": 2},
            {"op": "conv", "k": 5, "cin": u[1], "cout": u[2], "stride": 1, "dilation": 1}]


def picker3d_flops_per_voxel(layers: List[dict]) -> int:
    """Dense scoring's operations a voxel of the map (a multiply-add counts
    two): every convolution of the filled network at stride 1, k^3 taps,
    and the 1x1x1 classifier; batch norm's per-channel affine step is not
    counted."""
    total = 0
    for layer in layers:
        if layer["op"] == "conv":
            total += 2 * layer["k"] ** 3 * layer["cin"] * layer["cout"]
        else:
            total += 2 * 27 * layer["cin"] * layer["hidden"]
            total += 2 * 27 * layer["hidden"] * layer["cout"]
            if layer["cin"] != layer["cout"]:
                total += 2 * layer["cin"] * layer["cout"]
    return total + 2 * layers[-1]["cout"]


def _norm(h: torch.Tensor, w: Dict[str, torch.Tensor], bn: str) -> torch.Tensor:
    """Eval-mode batch norm ``bn`` (a key prefix) when the weights hold it."""
    if bn + ".scale" not in w:
        return h
    return F.batch_norm(h, w[bn + ".mean"], w[bn + ".var"], w[bn + ".scale"], w[bn + ".bias"],
                        training=False, eps=1e-5)


def _dense(h: torch.Tensor, layers: List[dict], w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The filled network on (1, 1, D, H, W); VALID convolutions, so each
    axis loses the receptive field less one."""
    acc = 1
    for i, layer in enumerate(layers):
        p = f"features.{i}."
        if layer["op"] == "conv":
            h = F.conv3d(h, w[p + "conv_w"], w.get(p + "conv_b"),
                         dilation=layer["dilation"] * acc)
            h = F.relu(_norm(h, w, p + "bn"))
        else:
            d0, d1 = acc, layer["dilation"] * acc
            y = F.conv3d(h, w[p + "conv0_w"], w.get(p + "conv0_b"), dilation=d0)
            y = F.relu(_norm(y, w, p + "bn0"))
            y = F.conv3d(y, w[p + "conv1_w"], w.get(p + "conv1_b"), dilation=d1)
            e = d0 + d1
            skip = h[..., e:-e, e:-e, e:-e]
            if p + "proj_w" in w:
                skip = F.conv3d(skip, w[p + "proj_w"])
            h = F.relu(_norm(y + skip, w, p + "bn1"))
        acc *= layer["stride"]
    return F.conv3d(h, w["classifier.w"], w["classifier.b"])[0, 0]


def picker3d_scores(x: torch.Tensor, layers: List[dict], w: Dict[str, torch.Tensor],
                    slab: int = 32, tf32: bool = False) -> torch.Tensor:
    """Dense score map (D, H, W) of one (D, H, W) float32 tomogram, on its
    device, computed ``slab`` output planes at a time."""
    pad = receptive_field(layers) // 2
    xp = F.pad(x[None, None], (pad,) * 6)
    D = x.shape[0]
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
        for z0 in range(0, D, slab):
            z1 = min(D, z0 + slab)
            out[z0:z1] = _dense(xp[:, :, z0:z1 + 2 * pad], layers, w)
    return out


def _sphere_chords(r: int) -> Dict[int, List[tuple]]:
    """{x half-width: [(dz, dy), ...]} of the integer sphere of radius r."""
    groups: Dict[int, List[tuple]] = {}
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            m = r * r - dz * dz - dy * dy
            if m >= 0:
                groups.setdefault(math.isqrt(m), []).append((dz, dy))
    return groups


def sphere_max(x: torch.Tensor, r: int) -> torch.Tensor:
    """Max of (D, H, W) float ``x`` over each voxel's integer sphere of
    radius ``r``, clipped at the edges: one x-chord max a half-width (a max
    pool with -inf padding), shifted into place for each (dz, dy)."""
    D, H, W = x.shape
    out = torch.full_like(x, -math.inf)
    for w, offsets in _sphere_chords(int(r)).items():
        chord = F.max_pool3d(x[None, None], (1, 1, 2 * w + 1), stride=1,
                             padding=(0, 0, w))[0, 0]
        for dz, dy in offsets:
            dst = (slice(max(0, -dz), D - max(0, dz)), slice(max(0, -dy), H - max(0, dy)))
            src = (slice(max(0, dz), D + min(0, dz)), slice(max(0, dy), H + min(0, dy)))
            out[dst] = torch.maximum(out[dst], chord[src])
    return out


def _too_close(c: torch.Tensor, r: int, block: int = 512) -> bool:
    """Whether two of the (K, 3) integer points lie within ``r``."""
    K = c.shape[0]
    for a in range(0, K, block):
        d2 = ((c[a:a + block, None, :] - c[None, :, :]) ** 2).sum(-1)
        rows = torch.arange(a, min(K, a + block), device=c.device)
        d2[rows - a, rows] = r * r + 1
        if bool((d2 <= r * r).any()):
            return True
    return False


def pick_gap_3d(S: torch.Tensor, scores, coords, r: int, t: float) -> float:
    """The widest relative violation of greedy NMS's conditions by one
    tomogram's picks (``scores`` (K,), ``coords`` (K, 3) as (x, y, z))
    against the reference map ``S`` (D, H, W), each over max(1, |S|): a
    pick's score off S, a pick not above ``t``, and a voxel above ``t``
    that is no pick and lies within ``r`` of no pick scoring at least as
    high. Greedy NMS at (r, t) yields exactly the pick sets with none of
    these; a map computed in another order or precision moves each by at
    most twice its error. Two picks within ``r`` of each other, a pick off
    the volume or a count of scores and coordinates that differ is no
    rounding and reads ``FAULT``."""
    D, H, W = S.shape
    coords = np.asarray(coords, dtype=np.int64)
    K = len(scores)
    if coords.size != 3 * K:
        return FAULT
    coords = coords.reshape(K, 3)
    xs, ys, zs = coords[:, 0], coords[:, 1], coords[:, 2]
    if K and ((xs < 0).any() or (xs >= W).any() or (ys < 0).any() or (ys >= H).any()
              or (zs < 0).any() or (zs >= D).any()):
        return FAULT
    dev = S.device
    if K > 1 and _too_close(torch.as_tensor(coords, device=dev), int(r)):
        return FAULT
    zi, yi, xi = (torch.as_tensor(v, device=dev) for v in (zs, ys, xs))
    Sp = S[zi, yi, xi]
    rel = lambda v, ref: v / torch.clamp(ref.abs(), min=1.0)  # noqa: E731
    gap = torch.zeros((), dtype=torch.float32, device=dev)
    if K:
        prog = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=dev)
        gap = torch.maximum(gap, rel((prog - Sp).abs(), Sp).max())
        gap = torch.maximum(gap, rel(torch.clamp(t - Sp, min=0), Sp).max())
    marks = torch.full_like(S, -math.inf)
    marks[zi, yi, xi] = Sp
    M = sphere_max(marks, int(r))
    del marks
    other = S > t
    other[zi, yi, xi] = False
    short = torch.where(M > -math.inf, torch.clamp(S - M, min=0), S - t)
    gap = torch.maximum(gap, torch.where(other, rel(short, S), 0).max())
    return float(gap)


def greedy_nms_3d(S: torch.Tensor, r: int, t: float) -> torch.Tensor:
    """Mask of the greedy picks of a (D, H, W) map: voxels above ``t``, each
    pick suppressing its sphere, in parallel rounds (a voxel that is the
    largest active one in its sphere, ties to the larger linear index, is
    taken; then every taken voxel's sphere is suppressed)."""
    D, H, W = S.shape
    lin = torch.arange(D * H * W, dtype=torch.float64, device=S.device).reshape(D, H, W)
    active = S > t
    taken = torch.zeros_like(active)
    while bool(active.any()):
        masked = torch.where(active, S, -math.inf)
        is_max = active & (masked >= sphere_max(masked, r))
        del masked
        idx = torch.where(is_max, lin, -1.0)
        peaks = is_max & (lin >= sphere_max(idx, r))
        del idx
        active &= ~(sphere_max(peaks.float(), r) > 0)
        taken |= peaks
    return taken
