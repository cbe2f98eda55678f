"""Preprocessing workflow: per-micrograph Fourier downsampling and GMM
normalization (port of topaz_tpu/preprocess.py:23-324, the reference's
topaz/stats.py:17-33,282-355). Each image's downsample and GMM fit run on
the device, or, batched, the fits of ``batch_size`` shape-bucketed images at
once; loader threads keep the next files read meanwhile. Also the particle
pixel count behind training's pi."""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

import numpy as np

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.io.image import load_image, save_image
from topaz_tpu_torch.ops.fourier import downsample
from topaz_tpu_torch.ops.gmm import normalize


def pixels_given_radius(radius: int, dims: int = 2) -> int:
    """Pixels a particle counts for in training's pi and p_observed (port of
    topaz_tpu/preprocess.py:23-43), exactly as the reference counts them
    (topaz/stats.py:17-25), 2D over-count included: it sums the 2D disk over
    all 2r+1 planes of a 3D grid, so r = 3 gives 203, not 29. ``-n`` and
    ``--pi`` mean what they mean in the reference only with this count.
    Training labels use the true disk (train/data.expand_target_points)."""
    grid = np.arange(-radius, radius + 1)
    d2 = grid[:, None] ** 2 + grid[None, :] ** 2
    if dims == 3:
        d2 = d2[:, :, None] + grid[None, None, :] ** 2
        return int((d2 <= radius**2).sum())
    disk = int((d2 <= radius**2).sum())
    return disk * (2 * radius + 1)


def calculate_pi(expected_num_particles: float, radius: int, total_pixels: int,
                 dims: int = 2) -> float:
    """Expected positive fraction from particle count and radius
    (topaz/stats.py:28-33)."""
    return pixels_given_radius(radius, dims=dims) * expected_num_particles / total_pixels


def normalize_file(
    path: str,
    dest: str,
    scale: int = 1,
    affine: bool = False,
    num_iters: int = 100,
    alpha: float = 900,
    beta: float = 1,
    sample: int = 1,
    metadata: bool = False,
    formats: Optional[List[str]] = None,
    seed: int = 0,
    bins: int = 0,
    loaded=None,
    device="cuda",
) -> str:
    """Normalize one image file and write outputs (topaz/stats.py:296-335).
    ``loaded`` lets a prefetch thread hand in the already-read image."""
    device = resolve_device(device)
    formats = formats or ["mrc"]
    if loaded is None:
        loaded = load_image(path, return_header=True)
    image, header, ext_header = loaded
    x = np.asarray(image, dtype=np.float32)

    if scale > 1:
        # keep the header's original nx/ny: mrc.write's shape-mismatch
        # branch rescales mx/my with nx/ny so the voxel spacing stays right
        x = downsample(x, scale, device=device).cpu().numpy()

    method = "affine" if affine else "gmm"
    x, md = normalize(x, alpha=alpha, beta=beta, num_iters=num_iters,
                      method=method, sample=sample, seed=seed, bins=bins,
                      device=device)

    name = os.path.splitext(os.path.basename(path))[0]
    base = os.path.join(dest, name)
    for f in formats:
        save_image(x, base, f=f, header=header, extended_header=ext_header)

    if metadata:
        if not affine:
            for k in ("mus", "stds", "pis", "logps"):
                md[k] = np.asarray(md[k]).tolist()
        with open(base + ".metadata.json", "w") as fh:
            json.dump(md, fh, indent=4)
    return name


def normalize_images_batched(
    paths: List[str],
    dest: str,
    scale: int = 1,
    affine: bool = False,
    num_iters: int = 100,
    alpha: float = 900,
    beta: float = 1,
    metadata: bool = False,
    formats: Optional[List[str]] = None,
    verbose: bool = False,
    bins: int = 0,
    num_workers: int = 2,
    batch_size: int = 1,
    bucket_step: int = 64,
    skip_errors: bool = False,
    device="cuda",
) -> None:
    """Batched normalization (port of topaz_tpu/preprocess.py:99-289, one
    device): micrographs are grouped into rounded shape buckets, zero-padded
    and masked as in pipeline.py, and ``batch_size`` images fit their GMMs
    at once. Loader threads read and downsample (scipy) the next files
    meanwhile.

    The fit uses all valid pixels (exact weighted EM; ``bins > 0`` the
    histogram EM); the reference's ``--sample`` subsampling is a CPU-cost
    workaround the batched path does not need.
    """
    import warnings
    from collections import defaultdict

    import torch

    from topaz_tpu_torch.ops.gmm import norm_fit, norm_fit_hist
    from topaz_tpu_torch.pipeline import _image_shape
    from topaz_tpu_torch.utils.batching import (fetch_async, iterate_prefetched,
                                                 load_batches, round_bucket, valid_mask)

    device = resolve_device(device)
    formats = formats or ["mrc"]
    os.makedirs(dest, exist_ok=True)
    batch_size = max(1, int(batch_size))

    def ds_shape(shape):
        if scale > 1:
            return (int(shape[0] / scale), int(shape[1] / scale))
        return tuple(shape)

    buckets = defaultdict(list)
    for p in paths:
        try:
            shape = _image_shape(p)
        except Exception:
            if not skip_errors:
                raise
            warnings.warn(f"{p}: unreadable header — skipped (--skip-errors)")
            continue
        buckets[round_bucket(ds_shape(shape), bucket_step)].append(p)

    @torch.inference_mode()
    def fit_batch(padded, valid):
        B = padded.shape[0]
        maskf = valid_mask(padded.shape[1:], valid).to(padded.dtype)
        xf, wf = padded.reshape(B, -1), maskf.reshape(B, -1)
        if affine:
            n = torch.sum(wf, dim=1)
            mu = torch.sum(xf * wf, dim=1) / n
            std = torch.sqrt(torch.sum(wf * (xf - mu[:, None]) ** 2, dim=1) / n)
            # dead-frame guard (see ops/gmm._guard_degenerate): report the
            # true std but divide by 1, so the output is zeros, not NaN
            stats = (mu, torch.where(std > 0, std, torch.ones_like(std)), std)
        elif bins > 0:
            stats = norm_fit_hist(xf, bins=bins, alpha=alpha, beta=beta,
                                  num_iters=num_iters, w=wf)
        else:
            stats = norm_fit(xf, alpha=alpha, beta=beta, num_iters=num_iters, w=wf)
        mu, std = stats[0], stats[1]
        out = (padded - mu[:, None, None]) / std[:, None, None] * maskf
        return (out,) + tuple(stats)

    def load_one(path, bucket):
        image, header, ext_header = load_image(path, return_header=True)
        x = np.asarray(image, dtype=np.float32)
        if scale > 1:
            from topaz_tpu_torch.ops.fourier import downsample_numpy

            # the header keeps its original nx/ny, see normalize_file
            x = downsample_numpy(x, scale, shape=ds_shape(x.shape))
        out = np.zeros(bucket, np.float32)
        out[: x.shape[0], : x.shape[1]] = x
        return out, x.shape, header, ext_header

    def produce():
        for bucket, items in buckets.items():
            for chunk, loaded in load_batches(
                    items, lambda p, b=bucket: load_one(p, b), batch_size,
                    batch_size + max(1, num_workers), num_workers=num_workers,
                    skip_errors=skip_errors):
                arr = np.stack([l[0] for l in loaded])
                valid = np.array([l[1] for l in loaded], dtype=np.int64)
                yield (chunk, arr, valid, [l[2] for l in loaded], [l[3] for l in loaded])

    for chunk, arr, valid, headers, ext_headers in iterate_prefetched(produce, maxsize=2):
        out = fit_batch(torch.from_numpy(arr).to(device), torch.from_numpy(valid).to(device))
        normed, *stats = fetch_async(*out)
        for i, path in enumerate(chunk):
            name = os.path.splitext(os.path.basename(path))[0]
            base = os.path.join(dest, name)
            vh, vw = valid[i]
            img = normed[i, :vh, :vw]
            # dead frames: affine carries the true std as stats[2], the GMM
            # signals with logp = -inf (ops/gmm._guard_degenerate)
            if (affine and float(stats[2][i]) == 0) or \
                    (not affine and np.isneginf(stats[3][i])):
                warnings.warn(
                    f"{path}: constant image (std=0) — normalized output is all "
                    f"zeros (the reference NaNs such frames)")
            for f in formats:
                save_image(img, base, f=f, header=headers[i], extended_header=ext_headers[i])
            if metadata:
                if affine:
                    md = {"mu": float(stats[0][i]), "std": float(stats[2][i]), "pi": 1}
                else:
                    mu, std, pi, logp, mus, stds, pis, logps = (s[i] for s in stats)
                    md = {"mu": float(mu), "std": float(std),
                          "pi": float(pi), "logp": float(logp),
                          "mus": mus.tolist(), "stds": stds.tolist(),
                          "pis": pis.tolist(), "logps": logps.tolist(),
                          "alpha": alpha, "beta": beta,
                          "sample": 1, "bins": int(bins)}
                with open(base + ".metadata.json", "w") as fh:
                    json.dump(md, fh, indent=4)
            if verbose:
                print("# processed:", name, file=sys.stderr)


def normalize_images(
    paths: List[str],
    dest: str,
    scale: int = 1,
    affine: bool = False,
    num_iters: int = 100,
    alpha: float = 900,
    beta: float = 1,
    sample: int = 1,
    metadata: bool = False,
    formats: Optional[List[str]] = None,
    verbose: bool = False,
    bins: int = 0,
    num_workers: int = 2,
    device="cuda",
) -> None:
    """Normalize a set of images one at a time (topaz/stats.py:338-355)."""
    from topaz_tpu_torch.utils.batching import window_batches

    device = resolve_device(device)
    os.makedirs(dest, exist_ok=True)
    for (path,), _, (loaded,) in window_batches(
            list(paths), lambda p: load_image(p, return_header=True),
            1, max(1, num_workers) + 1, num_workers=num_workers):
        name = normalize_file(
            path, dest, scale=scale, affine=affine, num_iters=num_iters,
            alpha=alpha, beta=beta, sample=sample, metadata=metadata,
            formats=formats, bins=bins, loaded=loaded, device=device,
        )
        if verbose:
            print("# processed:", name, file=sys.stderr)
