"""Particle extraction: dense scoring + greedy NMS + coordinate table (port
of topaz_tpu/extract.py:38-83,164-306, the reference's topaz/extract.py).

Each micrograph is scored whole on the device and its score map stays
there for the NMS rounds, whose disk max-filter is the CUDA kernel; only
the accepted peaks come back to the host. Output is the single table
(image_name, x_coord, y_coord, score) on stdout or in one file.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Iterator, List, Optional, TextIO, Tuple

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.ops.nms import non_maximum_suppression
from topaz_tpu_torch.utils.printing import report


def stream_inputs(f: TextIO) -> Iterator[str]:
    """Yield non-empty stripped lines (stdin streaming, extract.py:271)."""
    for line in f:
        line = line.strip()
        if line:
            yield line


def score_images(model: Optional[str], paths: Iterable[str],
                 device="cuda") -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (path, dense (H, W) score map on ``device``) per micrograph
    (topaz/extract.py:224-256), scoring each whole image. ``model='none'``
    passes images through as already-computed score maps."""
    device = resolve_device(device)
    picker = None
    if model is not None and model != "none":
        from topaz_tpu_torch.models.factory import load_picker

        picker = load_picker(model, device=device)
    for path in paths:
        # a copy: arrays read from files are read-only
        image = np.array(load_image(path), dtype=np.float32)
        if image.ndim != 2:
            raise NotImplementedError(
                f"{path}: scoring {image.ndim}D images (tomograms) is not yet "
                f"ported to topaz_tpu_torch")
        x = torch.from_numpy(image).to(device)
        if picker is None:
            yield path, x
            continue
        with torch.inference_mode():
            yield path, picker(x[None])[0]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to topaz_tpu_torch")


def extract_particles(
    paths: List[str],
    model: Optional[str],
    threshold: float,
    radius: Optional[int],
    targets: Optional[str] = None,
    patch_size: int = 0,
    batch_size: int = 1,
    only_validate: bool = False,
    output: Optional[str] = None,
    per_micrograph: bool = False,
    up_scale: float = 1.0,
    down_scale: float = 1.0,
    dims: int = 2,
    verbose: bool = False,
    device="cuda",
) -> None:
    """Score, run NMS and write the coordinate table
    (topaz/extract.py:266-367)."""
    if targets is not None or only_validate:
        raise _not_ported("--targets/--only-validate (radius search and "
                          "validation against labeled targets)")
    if per_micrograph:
        raise _not_ported("--per-micrograph output")
    if batch_size > 1:
        raise _not_ported("batched scoring (--batch-size > 1)")
    if patch_size:
        raise _not_ported("patch scoring (--patch-size)")
    if dims != 2:
        raise _not_ported("3D extraction (--dims 3)")
    if radius is None or radius < 0:
        raise ValueError(
            "Must specify targets for choosing the extraction radius if "
            "extraction radius is not provided")
    device = resolve_device(device)

    report("Beginning extraction")
    paths = list(paths) if paths else list(stream_inputs(sys.stdin))
    scale = up_scale / down_scale

    if output is not None and os.path.isdir(output):
        output = os.path.join(output, "extracted_particles.txt")
    f = sys.stdout if output is None else open(output, "w")
    try:
        print("image_name\tx_coord\ty_coord\tscore", file=f)
        for path, score in score_images(model, paths, device=device):
            name = os.path.splitext(os.path.basename(path))[0]
            s, coords = non_maximum_suppression(score, radius, threshold=threshold,
                                                device=device)
            if verbose:
                report(f"Extracted {len(s)} particles from {name}")
            if scale != 1:
                coords = np.round(coords * scale).astype(int)
            for i in range(len(s)):
                print(f"{name}\t{coords[i, 0]}\t{coords[i, 1]}\t{s[i]}", file=f)
    finally:
        if f is not sys.stdout:
            f.close()
    report("Extraction complete")
