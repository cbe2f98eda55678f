"""Particle coordinates rasterized into masks, matched to images, scaled,
and cut into a particle stack (port of topaz_tpu/ops/masks.py, the
reference's topaz/utils/picks.py and topaz/utils/data/coordinates.py).

Ones are scattered at the particle centers and dilated by the integer disk
(or sphere); the reference convolves with a disk kernel and binarizes, which
gives the same mask. Host numpy: training rasterizes the test targets once
an epoch.

``create_particle_stack`` cuts the crops on the host, as the JAX package
does; with ``resize`` it Fourier-downsamples all crops of a micrograph in
one batched call on the device (``ops.fourier.downsample``) and
standardizes each there. Without ``resize`` it is numpy only, and its bytes
are the JAX package's.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np

from topaz_tpu_torch.io.table import Table, concat, read_csv


def _disk_chords(radius: float):
    R = int(math.floor(radius))
    return [(dy, int(math.floor(math.sqrt(radius * radius - dy * dy))))
            for dy in range(-R, R + 1)]


def _dilate_rows(mask: np.ndarray, radius: float) -> np.ndarray:
    """Binary dilation of the last two axes by the integer disk."""
    H, W = mask.shape[-2:]
    out = np.zeros_like(mask)
    for dy, w in _disk_chords(radius):
        ys = slice(max(0, -dy), min(H, H - dy))
        yd = slice(max(0, dy), min(H, H + dy))
        rows = mask[..., ys, :]
        # horizontal dilation width 2w+1 via padded sliding-window any
        if w > 0:
            p = np.pad(rows, [(0, 0)] * (rows.ndim - 1) + [(w, w)])
            acc = np.zeros_like(rows, dtype=bool)
            for dx in range(2 * w + 1):
                acc |= p[..., dx:dx + W].astype(bool)
            rows = acc
        out[..., yd, :] |= rows.astype(bool)
    return out


def as_mask(shape: Tuple[int, ...], radius: float, x_coord, y_coord,
            z_coord=None) -> np.ndarray:
    """Float32 mask of all pixels within ``radius`` of any coordinate
    (topaz/utils/picks.py:16-50)."""
    mask = np.zeros(shape, dtype=bool)
    x = np.asarray(x_coord, dtype=int)
    y = np.asarray(y_coord, dtype=int)
    if z_coord is not None:
        z = np.asarray(z_coord, dtype=int)
        mask[z, y, x] = True
        R = int(math.floor(radius))
        out = np.zeros_like(mask)
        for dz in range(-R, R + 1):
            rem = radius * radius - dz * dz
            if rem < 0:
                continue
            zs = slice(max(0, -dz), min(shape[0], shape[0] - dz))
            zd = slice(max(0, dz), min(shape[0], shape[0] + dz))
            out[zd] |= _dilate_rows(mask[zs], math.sqrt(rem))
        return out.astype(np.float32)
    mask[y, x] = True
    return _dilate_rows(mask, radius).astype(np.float32)


def _as_table(coords) -> Table:
    return coords if isinstance(coords, Table) else coords.to_table()


def coordinates_table_to_dict(coords) -> Dict:
    """{image_name: (N, 2 or 3) coordinates}, or {source: {image_name: ...}}
    when the table has a ``source`` column (topaz/utils/data/coordinates.py:
    10-23); ``coords`` is a ``Table`` or a ``Coordinates``."""
    table = _as_table(coords)
    cols = ["x_coord", "y_coord"] + (["z_coord"] if "z_coord" in table else [])

    def by_name(t):
        return {name: np.stack([g[c] for c in cols], axis=1)
                for name, g in t.groupby("image_name")}

    if "source" in table:
        return {source: by_name(group) for source, group in table.groupby("source")}
    return by_name(table)


def match_coordinates_to_images(coords, images: Dict, radius: float = -1) -> Dict:
    """Pair loaded images with their coordinates, or with masks of
    ``radius`` when it is not negative (spheres for 3D volumes)
    (topaz/utils/data/coordinates.py:38-64); images without coordinates
    get none. ``images`` is {name: image}, or {source: {name: image}} for a
    table with a ``source`` column."""
    table = _as_table(coords)
    nested = "source" in table
    coords_dict = coordinates_table_to_dict(table)
    null = np.zeros((0, 3 if "z_coord" in table else 2), dtype=np.int32)

    def rasterize(im, c):
        if radius < 0:
            return c
        if np.ndim(im) == 3 and c.shape[1] >= 3:
            return as_mask(im.shape, radius, c[:, 0], c[:, 1], z_coord=c[:, 2])
        return as_mask(im.shape, radius, c[:, 0], c[:, 1])

    if nested:
        return {source: {name: (im, rasterize(im, coords_dict.get(source, {}).get(name, null)))
                         for name, im in group.items()}
                for source, group in images.items()}
    return {name: (im, rasterize(im, coords_dict.get(name, null)))
            for name, im in images.items()}


def scale_coordinates_file(input_file: str, scale: float,
                           output_file: Optional[str] = None) -> None:
    """Scale the coordinates of a coordinate table for a resized image,
    rounding half to even, and a ``diameter`` column up
    (topaz/utils/picks.py:53-68); every other column is kept."""
    table = read_csv(input_file, str_columns=("image_name",))
    if "diameter" in table:
        table["diameter"] = np.ceil(table["diameter"] * scale).astype(np.int32)
    table["x_coord"] = np.round(table["x_coord"] * scale).astype(np.int32)
    table["y_coord"] = np.round(table["y_coord"] * scale).astype(np.int32)
    out = sys.stdout if output_file is None else open(output_file, "w")
    try:
        table.write_csv(out)
    finally:
        if output_file is not None:
            out.close()


def _standardized_crops(micrograph: np.ndarray, xs, ys, size: int, dtype) -> np.ndarray:
    """(n, mz, size, size) crops centred on (x, y), each standardized over
    its part inside the micrograph, zero outside, in ``dtype``
    (topaz/utils/picks.py:150-170)."""
    _, n, m = micrograph.shape
    out = np.zeros((len(xs), micrograph.shape[0], size, size), dtype=dtype)
    for k, (x, y) in enumerate(zip(xs, ys)):
        left, upper = x - size // 2, y - size // 2
        right, lower = left + size, upper + size
        c = micrograph[:, max(0, upper):min(n, lower), max(0, left):min(m, right)]
        c = (c - c.mean()) / c.std()
        out[k, :, max(0, -upper):min(size + n - lower, size),
            max(0, -left):min(size + m - right, size)] = c
    return out


def resize_crops(crops: np.ndarray, resize: int, device="cuda") -> np.ndarray:
    """Fourier-downsample (n, mz, size, size) crops to resize^2 in one call
    on ``device`` and standardize each crop over its (mz, resize, resize)
    (population std); float32 on the host."""
    from topaz_tpu_torch.ops.fourier import downsample

    small = downsample(crops.astype(np.float32), shape=(resize, resize), device=device)
    mean = small.mean(dim=(1, 2, 3), keepdim=True)
    std = small.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
    return ((small - mean) / std).cpu().numpy()


def create_particle_stack(input_file: str, output_file: str, threshold: float, size: int,
                          resize: int, image_root: str, image_ext: str,
                          metadata_file: Optional[str], device="cuda") -> None:
    """Cut the particles of a coordinate table into an MRC stack and write
    its STAR metadata beside it (topaz/utils/picks.py:71-197). Micrographs
    go in sorted name order; each crop is standardized with numpy's
    population std and written in the first micrograph's dtype (an
    integer dtype truncates). With ``resize`` (not -1 nor ``size``) the
    crops of a micrograph are downsampled together on ``device`` and
    standardized again, and DetectorPixelSize is scaled by size/resize.
    ``metadata_file``, a STAR table, joins by MicrographName (left join)."""
    from topaz_tpu_torch.io import mrc, star

    particles = read_csv(input_file, str_columns=("image_name",))
    print("#", "Loaded", len(particles), "particles", file=sys.stderr)
    if "score" in particles:
        particles = particles.take(particles["score"] >= threshold)
        print("#", "Thresholding at", threshold, file=sys.stderr)
    print("#", "Extracting", len(particles), "particles", file=sys.stderr)
    if resize < 0:
        resize = size
    if resize != size:
        from topaz_tpu_torch.device import resolve_device

        device = resolve_device(device)

    parts, mz, dtype = [], 1, None
    with open(output_file, "wb") as f:
        for image_name, coords in particles.groupby("image_name"):
            print("#", image_name, len(coords), "particles", file=sys.stderr)
            image_name = image_name + image_ext
            micrograph, header, _ = mrc.read(os.path.join(image_root, image_name))
            if micrograph.ndim < 3:
                micrograph = micrograph[np.newaxis]
            if dtype is None:
                mz, dtype = micrograph.shape[0], micrograph.dtype
                f.write(mrc.default_header(
                    (len(particles) * mz, resize, resize), dtype=dtype,
                    cella=(header.xlen, header.ylen, header.zlen),
                    cellb=(header.alpha, header.beta, header.gamma), mz=mz).tobytes())
            crops = _standardized_crops(micrograph, coords["x_coord"], coords["y_coord"],
                                        size, dtype)
            if resize != size:
                crops = resize_crops(crops, resize, device=device).astype(dtype)
            f.write(crops.tobytes())
            part = Table({"MicrographName": np.array([image_name] * len(coords), dtype=object),
                          star.X_COLUMN_NAME: coords["x_coord"],
                          star.Y_COLUMN_NAME: coords["y_coord"]})
            if "score" in coords:
                part[star.SCORE_COLUMN_NAME] = coords["score"]
            parts.append(part)

    stack_name = os.path.basename(output_file)
    metadata = concat(parts) if parts else Table(
        {c: np.zeros(0, dtype=object) for c in ["MicrographName", star.X_COLUMN_NAME,
                                                star.Y_COLUMN_NAME]
         + ([star.SCORE_COLUMN_NAME] if "score" in particles else [])})
    metadata["ImageName"] = np.array([f"{i + 1}@{stack_name}" for i in range(len(metadata))],
                                     dtype=object)
    if mz > 1:
        metadata["NrOfFrames"] = mz
    if metadata_file is not None:
        with open(metadata_file) as f:
            metadata = metadata.merge_left(Table(star.parse(f)), on="MicrographName")
    if resize != size and "DetectorPixelSize" in metadata:
        metadata["DetectorPixelSize"] = (metadata["DetectorPixelSize"].astype(float)
                                         * (size / resize))
    with open(os.path.splitext(output_file)[0] + ".star", "w") as f:
        star.write(metadata, f)
