"""Preprocessing workflow: per-micrograph Fourier downsampling and GMM
normalization (port of topaz_tpu/preprocess.py:53-96,292-324, the
reference's topaz/stats.py:282-355). Each image's downsample and GMM fit run
on the device; loader threads keep the next files read meanwhile."""

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
