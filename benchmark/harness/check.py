"""Whether what the timed path produced is correct: every answer of the
window (or a seeded sample of the denoised images) against the plain
reference of ``benchmark/reference``, run after the window on the same
input files and the same ``.npz`` weights.

Picks are judged by the reference's own score map S of the micrograph (no
second NMS to match pick for pick): greedy NMS at radius r and threshold t
yields exactly the pick sets P with (1) every pick above t, (2) no two
picks within r, and (3) every other pixel above t within r of a pick that
scores at least as high. A map computed in another order or precision
moves each condition by at most twice its error, so ``pick_gap`` is the
widest violation of (1) and (3) and of |score - S| at the picks, each over
max(1, |S|); a violation of (2), a pick off the image or a missing answer
is no rounding and reads ``FAULT``. Denoised images are judged by
``denoise_gap``, the largest |difference| over the reference output's
standard deviation.
"""

from __future__ import annotations

import copy
import math
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from harness.inputs import read_mrc
from reference import counts, model, nms, prep

# what a structural fault reads (picks too close, off the image, a wrong
# shape or a non-finite pixel): no rounding comes near it, and it stays a
# number in the result line
FAULT = 1e9


def pick_gap(S: torch.Tensor, scores, coords, r: int, t: float) -> float:
    """The widest relative violation of greedy NMS's conditions by one
    answer's picks (``scores`` (K,), ``coords`` (K, 2) as (x, y)) against
    the reference map ``S`` (H, W)."""
    H, W = S.shape
    K = len(scores)
    coords = np.asarray(coords, dtype=np.int64).reshape(K, 2)
    xs, ys = coords[:, 0], coords[:, 1]
    if K and ((xs < 0).any() or (xs >= W).any() or (ys < 0).any() or (ys >= H).any()):
        return FAULT
    if K > 1:
        d2 = (xs[:, None] - xs[None, :]) ** 2 + (ys[:, None] - ys[None, :]) ** 2
        np.fill_diagonal(d2, r * r + 1)
        if (d2 <= r * r).any():
            return FAULT
    dev = S.device
    yi, xi = torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev)
    Sp = S[yi, xi]
    rel = lambda v, ref: v / torch.clamp(ref.abs(), min=1.0)  # noqa: E731
    gap = torch.zeros((), dtype=torch.float32, device=dev)
    if K:
        prog = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=dev)
        gap = torch.maximum(gap, rel((prog - Sp).abs(), Sp).max())
        gap = torch.maximum(gap, rel(torch.clamp(t - Sp, min=0), Sp).max())
    marks = torch.full_like(S, -math.inf)
    marks[yi, xi] = Sp
    M = nms.disk_max(marks[None], r)[0]
    other = S > t
    other[yi, xi] = False
    short = torch.where(M > -math.inf, torch.clamp(S - M, min=0), S - t)
    gap = torch.maximum(gap, torch.where(other, rel(short, S), 0).max())
    return float(gap)


def answer_gap(maps: torch.Tensor, scores, coords, r: int, t: float) -> float:
    """``pick_gap`` against the closest of the reference's admitted score
    maps (C, H, W): the two whose scores at the picks lie nearest the
    program's are judged in full, and the smaller gap counts."""
    coords = np.asarray(coords, dtype=np.int64).reshape(len(scores), 2)
    if len(scores) and maps.shape[0] > 2 and (coords >= 0).all() and (
            coords[:, 0] < maps.shape[2]).all() and (coords[:, 1] < maps.shape[1]).all():
        yi = torch.as_tensor(coords[:, 1], device=maps.device)
        xi = torch.as_tensor(coords[:, 0], device=maps.device)
        prog = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=maps.device)
        near = (maps[:, yi, xi] - prog).abs().amax(dim=1)
        order = torch.argsort(near)[:2].tolist()
    else:
        order = range(min(2, maps.shape[0]))
    return min(pick_gap(maps[c], scores, coords, r, t) for c in order)


def denoise_gap(out, ref: torch.Tensor) -> float:
    out = torch.as_tensor(np.asarray(out), device=ref.device)
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        return FAULT
    return float((out.double() - ref.double()).abs().max() / ref.double().std(correction=0))


class Reference:
    """The reference's outputs for one configuration's input files, computed
    once a file; ``tf32=True`` gives the control (TF32 convolutions)."""

    def __init__(self, config: dict, root: str, device):
        self.cfg, self.device, self.tf32 = config, device, False
        self.picker_w = model.load_npz(f"{root}/{config['picker']['weights']}", device) \
            if "picker" in config else None
        self.unet_w = model.load_npz(f"{root}/{config['denoiser']['weights']}", device) \
            if "denoiser" in config else None

    def control(self) -> "Reference":
        """This reference with TF32 convolutions: the precision below the
        float32 with TF32 off that the configurations state."""
        low = copy.copy(self)
        low.tf32 = True
        return low

    def _flags(self):
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=self.tf32)

    def picks(self, paths: List[str], denoise: bool):
        """For micrograph files: {path: (score maps (C, H, W), the EM's
        posterior evaluations)}, one map for each normalization the EM
        admits (``prep.norm_fit``; the chosen one first), and with
        ``denoise`` {path: the denoise arm's output}."""
        path_cfg, gmm = self.cfg["path"], self.cfg["gmm"]
        ds = {p: prep.fourier_crop(torch.from_numpy(read_mrc(p).copy()).to(self.device),
                                   path_cfg["scale"]) for p in paths}
        by_shape = defaultdict(list)
        for p, x in ds.items():
            by_shape[tuple(x.shape)].append(p)
        maps, dens = {}, {}
        for shape, group in by_shape.items():
            x = torch.stack([ds[p] for p in group])
            _, _, steps, admitted = prep.norm_fit(
                x.reshape(len(group), -1), gmm["pis"], gmm["alpha"], gmm["beta"], gmm["tol"],
                gmm["num_iters"])
            with torch.no_grad(), self._flags():
                if denoise:
                    den = self._denoise_arm(x)
                for i, p in enumerate(group):
                    fits = torch.unique(torch.stack(admitted[i], dim=1)[1:], dim=0)
                    fits = torch.cat([torch.stack(admitted[i], dim=1)[:1], fits])
                    S = torch.cat([model.picker_scores((x[i] - f[:, 0]) / f[:, 1], self.cfg["picker"]["layers"],
                                                       self.picker_w)
                                   for f in torch.split(fits[:, :, None, None], 8)])
                    maps[p] = (S, counts.em_evaluations(shape[0] * shape[1], steps[i].tolist()))
                    if denoise:
                        dens[p] = den[i]
        return maps, dens

    def _denoise_arm(self, x: torch.Tensor) -> torch.Tensor:
        """The pipeline's denoise arm: each image standardized by its own
        statistics, zero-padded to its shape bucket, denoised, restored."""
        B, h, w = x.shape
        step = self.cfg["path"]["bucket_step"]
        bh, bw = -(-h // step) * step, -(-w // step) * step
        x64 = x.double()
        m = x64.mean(dim=(1, 2), keepdim=True)
        s = torch.sqrt(((x64 - m) ** 2).mean(dim=(1, 2), keepdim=True))
        z = torch.zeros((B, 1, bh, bw), dtype=torch.float32, device=x.device)
        z[:, 0, :h, :w] = ((x64 - m) / s).float()
        y = model.unet(z, self.unet_w)[:, 0, :h, :w]
        return (y.double() * s + m).float()

    def denoise_whole(self, image: np.ndarray) -> torch.Tensor:
        with torch.no_grad(), self._flags():
            return model.denoise_whole(torch.from_numpy(np.array(image)).to(self.device),
                                       self.unet_w)


def worst(values) -> float:
    values = list(values)
    return max(values) if values else 0.0


def control_picks(ref: Reference, files: List[str], denoise: bool) -> Dict[str, float]:
    """The control: the reference in TF32 in the program's place, its
    greedy picks and denoised images judged against the float32
    reference."""
    r, t = ref.cfg["path"]["radius"], ref.cfg["path"]["threshold"]
    low = ref.control()
    maps, dens = ref.picks(files, denoise)
    lmaps, ldens = low.picks(files, denoise)
    gaps = []
    for p in files:
        S = lmaps[p][0][0]
        taken = nms.greedy_nms(S[None], r, t)[0]
        ys, xs = torch.nonzero(taken, as_tuple=True)
        coords = torch.stack([xs, ys], dim=1).cpu().numpy()
        gaps.append(answer_gap(maps[p][0], S[ys, xs].cpu().numpy(), coords, r, t))
    out = {"pick_gap": worst(gaps)}
    if denoise:
        out["denoise_gap"] = worst([denoise_gap(ldens[p].cpu().numpy(), dens[p]) for p in files])
    return out


def control_denoise(ref: Reference, images: List[np.ndarray]) -> Dict[str, float]:
    low = ref.control()
    return {"denoise_gap": worst([denoise_gap(low.denoise_whole(x).cpu().numpy(),
                                               ref.denoise_whole(x)) for x in images])}
