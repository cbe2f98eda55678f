"""Particle extraction: dense scoring + greedy NMS + coordinate output (port
of topaz_tpu/extract.py:38-362, the reference's topaz/extract.py).

Each micrograph is scored on the device, whole or in tiles
(``patch_size``; tomograms always in 96^3 tiles), and its score map stays
there for the NMS rounds, whose 2D disk max-filter is the CUDA kernel; only
the accepted peaks come back to the host. ``batch_size > 1`` scores and
suppresses shape-bucketed batches through pipeline.MicrographPipeline;
``device=-2`` splits those batches over every device (a (data, space)
mesh, ``hybrid_mesh_for``), one micrograph a device by default.

With labeled ``targets`` every score map is kept on the device and the NMS
rounds run again on it at each radius of the grid (``find_opt_radius``), or
at the given radius, and the picks are matched to the targets on the host
(Hungarian assignment) for the AUPRC. Score maps are keyed by image name
(the file's base name without extension), the name the targets carry; the
JAX package keys them by path, so no target matches there.

A tomogram's picks come from ``pick_volume``, the one entry that the
``--dims 3`` route and in-process callers share: 96^3 tiles scored, then
the sphere NMS rounds on the device, with its stage spans (``extract3d/
tile``, ``score``, ``nms``, ``fetch``) and counters (this module's
``volumes_picked`` and ``output_voxels``, models/tiling.py's
``tiles_scored`` and ``network_voxels``).

Output is the single table (image_name, x_coord, y_coord[, z_coord], score)
on stdout or in one file, or one file a micrograph in the coord, star, box,
json or csv format.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, Iterator, List, Optional, TextIO, Tuple

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.parallel.devices import hybrid_mesh_for, resolve_devices
from topaz_tpu_torch.io.coordinates import Coordinates, read_coordinates, write_table
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.models.picker import Picker
from topaz_tpu_torch.ops.metrics import average_precision, match_coordinates
from topaz_tpu_torch.ops.nms import non_maximum_suppression, non_maximum_suppression_3d
from topaz_tpu_torch.utils.printing import report

# pick_volume's work in this process: tomograms picked and voxels of their
# score maps; callers may reset each to 0
volumes_picked = 0
output_voxels = 0


def stream_inputs(f: TextIO) -> Iterator[str]:
    """Yield non-empty stripped lines (stdin streaming, extract.py:271)."""
    for line in f:
        line = line.strip()
        if line:
            yield line


def image_name(path: str) -> str:
    """The name a micrograph goes by in coordinate tables."""
    return os.path.splitext(os.path.basename(path))[0]


def _images(model: Optional[str], paths: Iterable[str],
            device) -> Iterator[Tuple[str, Optional[Picker], np.ndarray]]:
    """(path, picker, image) per micrograph or tomogram, the picker loaded
    once (None for ``model`` None or 'none') and each image's dimensions
    checked against it."""
    picker = None
    if model is not None and model != "none":
        from topaz_tpu_torch.models.factory import load_picker

        picker = load_picker(model, device=device)
    for path in paths:
        # a copy: arrays read from files are read-only
        image = np.array(load_image(path), dtype=np.float32)
        if picker is not None and image.ndim != picker.spec.dims:
            raise ValueError(f"{path}: a {image.ndim}D image for a {picker.spec.dims}D "
                             f"picker (--dims {image.ndim} needs a {image.ndim}D model)")
        yield path, picker, image


def _score(picker: Optional[Picker], image: np.ndarray, patch_size: int,
           device) -> torch.Tensor:
    if picker is None:
        return torch.from_numpy(image).to(device)
    if image.ndim == 3:
        from topaz_tpu_torch.models.tiling import classify_patches_3d

        return classify_patches_3d(picker, image)
    if patch_size:
        from topaz_tpu_torch.models.tiling import predict_in_patches

        return predict_in_patches(picker, image, patch_size)
    with torch.inference_mode():
        return picker(torch.from_numpy(image).to(device)[None])[0]


def score_images(model: Optional[str], paths: Iterable[str], patch_size: int = 0,
                 device="cuda") -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (path, dense score map on ``device``) per micrograph
    (topaz_tpu/extract.py:38-80): whole-image scoring, or tiles of
    ``patch_size`` (``predict_in_patches``); a 3D volume goes through
    ``classify_patches_3d``. ``model='none'`` passes images through as
    already-computed score maps."""
    device = resolve_device(device)
    for path, picker, image in _images(model, paths, device):
        yield path, _score(picker, image, patch_size, device)


def pick_volume(picker: Picker, volume: np.ndarray, radius: int, threshold: float,
                patch_size: int = 96, batch_size: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """One (D, H, W) tomogram's picks with a 3D ``picker``: dense scoring in
    ``patch_size``^3 tiles of ``batch_size`` windows (``classify_patches_3d``,
    spans ``extract3d/tile`` and ``extract3d/score``), then greedy sphere NMS
    at ``radius`` above ``threshold`` on the picker's device
    (``non_maximum_suppression_3d``, spans ``extract3d/nms`` and
    ``extract3d/fetch``). Returns (scores, coords[x, y, z]) on the host,
    sorted by descending score."""
    from topaz_tpu_torch.models.tiling import classify_patches_3d

    global volumes_picked, output_voxels
    volume = np.asarray(volume, dtype=np.float32)
    if volume.ndim != 3 or picker.spec.dims != 3:
        raise ValueError(f"pick_volume takes a 3D volume and a 3D picker, got a "
                         f"{volume.ndim}D volume and a {picker.spec.dims}D picker")
    score = classify_patches_3d(picker, volume, patch_size, batch_size)
    picks = non_maximum_suppression_3d(score, radius, threshold=threshold, device=score.device)
    volumes_picked += 1
    output_voxels += score.numel()
    return picks


def iterate_score_target_pairs(scores: Dict[str, torch.Tensor], targets: Coordinates,
                               dims: int = 2):
    """Pair each image's score map with its target coordinates, (N, dims)
    as (x, y[, z]) (topaz_tpu/extract.py:96-102)."""
    if dims == 3 and targets.z_coord is None:
        raise ValueError("--dims 3 targets need a z_coord column")
    for name, score in scores.items():
        target = targets.for_image(name)
        cols = [target.x_coord, target.y_coord] + ([target.z_coord] if dims == 3 else [])
        yield score, np.stack(cols, axis=1)


def extract_auprc(targets: Coordinates, scores: Dict[str, torch.Tensor], radius: float,
                  threshold: float, match_radius: Optional[float] = None, dims: int = 2,
                  device="cuda") -> Tuple[float, float, int, int]:
    """(AUPRC, RMSE, matched targets, targets) of extraction at ``radius``
    against labeled targets (topaz_tpu/extract.py:105-141). The NMS rounds
    run on ``device``, where the score maps already lie; in 3D at ``radius
    * 2``, the JAX package's fix of the reference's 3D crash."""
    N = 0
    mse = 0.0
    hits = []
    preds = []
    for score, target in iterate_score_target_pairs(scores, targets, dims=dims):
        if dims == 2:
            s, coords = non_maximum_suppression(score, radius, threshold=threshold,
                                                device=device)
        else:
            s, coords = non_maximum_suppression_3d(score, radius * 2, threshold=threshold,
                                                   device=device)
        r = radius if match_radius is None else match_radius
        assignment, dist = match_coordinates(target, coords, r)
        mse += float(np.sum(dist[assignment == 1] ** 2))
        hits.append(assignment)
        preds.append(s)
        N += len(target)

    hits = np.concatenate(hits, 0) if hits else np.zeros(0, dtype=np.float32)
    preds = np.concatenate(preds, 0) if preds else np.zeros(0, dtype=np.float32)
    auprc = average_precision(hits, preds, N=N)
    total_hits = int(hits.sum())
    rmse = float(np.sqrt(mse / total_hits)) if total_hits > 0 else 0.0
    return auprc, rmse, total_hits, N


def find_opt_radius(targets: Coordinates, scores: Dict[str, torch.Tensor], threshold: float,
                    lo: int = 0, hi: int = 200, step: int = 10,
                    match_radius: Optional[float] = None, dims: int = 2,
                    device="cuda") -> Tuple[int, float]:
    """Grid-search the extraction radius that maximizes the AUPRC
    (topaz_tpu/extract.py:144-161), one line a radius on stdout; a tie goes
    to the smallest radius."""
    auprc = np.zeros(hi + 1) - 1
    for r in range(lo, hi + 1, step):
        au, rmse, recall, n = extract_auprc(targets, scores, r, threshold,
                                            match_radius=match_radius, dims=dims,
                                            device=device)
        auprc[r] = au
        print(f"# radius={r}, auprc={au}, rmse={rmse}, recall={recall}, targets={n}")
    r = int(np.argmax(auprc))
    return r, auprc[r]


def _open_outputs(output: Optional[str], per_micrograph: bool, dims: int):
    """(table stream or None, per-micrograph directory or None), with the
    JAX package's rules (topaz_tpu/extract.py:266-280): a directory ``-o``
    gets ``extracted_particles.txt`` or the per-micrograph files; a file
    ``-o`` with ``--per-micrograph`` puts them into ``COORDS/`` beside it."""
    if not per_micrograph:
        if output is not None and os.path.isdir(output):
            output = os.path.join(output, "extracted_particles.txt")
        f = sys.stdout if output is None else open(output, "w")
        z_string = "\tz_coord" if dims == 3 else ""
        print(f"image_name\tx_coord\ty_coord{z_string}\tscore", file=f)
        return f, None
    if os.path.isdir(output):
        return None, output
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    output_dir = os.path.join(os.path.dirname(output), "COORDS")
    os.makedirs(output_dir, exist_ok=True)
    return None, output_dir


def _write_picks(picks, output: Optional[str], per_micrograph: bool, suffix: str,
                 out_format: str, scale: float, dims: int, verbose: bool) -> None:
    """Write (path, scores, coords) picks as the single table or one file a
    micrograph (topaz_tpu/extract.py:282-306, 341-362)."""
    f, output_dir = _open_outputs(output, per_micrograph, dims)
    try:
        for path, s, coords in picks:
            name, ext = os.path.splitext(os.path.basename(path))
            if verbose:
                report(f"Extracted {len(s)} particles from {name}")
            if scale != 1:
                coords = np.round(coords * scale).astype(int)
            if per_micrograph:
                table = Coordinates(np.array([name] * len(s), dtype=object), coords[:, 0],
                                    coords[:, 1], z_coord=coords[:, 2] if dims == 3 else None,
                                    score=s)
                out_path = os.path.join(output_dir, name + suffix + "." + out_format)
                with open(out_path, "w") as pf:
                    write_table(pf, table, format=out_format, image_ext=ext)
                continue
            for i in range(len(s)):
                z_coord = f"\t{coords[i, 2]}" if dims == 3 else ""
                print(f"{name}\t{coords[i, 0]}\t{coords[i, 1]}{z_coord}\t{s[i]}", file=f)
    finally:
        if f is not None and f is not sys.stdout:
            f.close()


def extract_particles(
    paths: List[str],
    model: Optional[str],
    threshold: float,
    radius: Optional[int],
    targets: Optional[str] = None,
    min_radius: int = 5,
    max_radius: int = 100,
    step: int = 5,
    match_radius: Optional[int] = None,
    patch_size: int = 0,
    batch_size: int = 1,
    only_validate: bool = False,
    output: Optional[str] = None,
    per_micrograph: bool = False,
    suffix: str = "",
    out_format: str = "coord",
    up_scale: float = 1.0,
    down_scale: float = 1.0,
    dims: int = 2,
    verbose: bool = False,
    device="cuda",
    skip_errors: bool = False,
) -> None:
    """Score, validate or search the radius against ``targets``, run NMS
    and write the picks (topaz_tpu/extract.py:164-362). With ``batch_size >
    1``, a model, a radius and neither targets nor patches, 2D micrographs
    go through the batched pipeline; ``skip_errors`` lets it go on past
    unreadable files. ``device=-2`` takes every device: batches (of one
    micrograph a device unless ``batch_size`` says more) are split over
    them; the paths that score one micrograph at a time run on the first,
    with a warning, as in the JAX package."""
    radius = radius if radius is not None else -1
    if targets is None and radius < 0:
        raise ValueError(
            "Must specify targets for choosing the extraction radius if "
            "extraction radius is not provided")
    if per_micrograph and output is None and not only_validate:
        raise ValueError("--per-micrograph writes its files into -o/--output (a "
                         "directory, or a file path whose directory gets COORDS/)")
    every = isinstance(device, int) and device == -2
    devices = resolve_devices(device)
    device = devices[0]
    if every and batch_size <= 1:
        batch_size = len(devices)

    report("Beginning extraction")
    paths = list(paths) if paths else list(stream_inputs(sys.stdin))
    scale = up_scale / down_scale

    use_batched = (batch_size > 1 and model not in (None, "none") and dims == 2
                   and targets is None and not patch_size and not only_validate)
    if every and len(devices) > 1 and not use_batched:
        print("# WARNING: -d -2 multi-device scoring needs the batched path (2D, a "
              "model, an explicit radius, and no --targets/--only-validate/"
              "--patch-size); scoring on one device", file=sys.stderr)
    if use_batched:
        from topaz_tpu_torch.pipeline import MicrographPipeline

        mesh = hybrid_mesh_for(devices if every else None, batch_size, warn=True)
        if mesh is not None:
            nd, ns = mesh.shape["data"], mesh.shape["space"]
            report(f"Batched scoring sharded over {nd * ns} devices"
                   + (f" ({nd} batch x {ns} spatial)" if ns > 1 else ""))
        pipe = MicrographPipeline(model=model, scale=1, radius=radius,
                                  threshold=threshold, normalize=False, mesh=mesh,
                                  skip_errors=skip_errors, device=device)
        _write_picks(pipe.process(paths, batch_size=batch_size), output, per_micrograph,
                     suffix, out_format, scale, dims, verbose)
        report("Extraction complete")
        return

    images = _images(model, paths, device)
    if targets is not None:
        scores = {image_name(path): _score(picker, image, patch_size, device)
                  for path, picker, image in images}
        table = read_coordinates(targets)
        names = dict.fromkeys(table.image_name.tolist())
        target_scores = {name: scores[name] for name in names if name in scores}
        if radius < 0:
            report("Finding optimal radius for extraction")
            radius, auprc = find_opt_radius(table, target_scores, threshold, lo=min_radius,
                                            hi=max_radius, step=step,
                                            match_radius=match_radius, dims=dims,
                                            device=device)
            report(f"Optimal radius found: {radius} with AUPRC: {auprc}")
        else:
            au, rmse, recall, n = extract_auprc(table, target_scores, radius, threshold,
                                                match_radius=match_radius, dims=dims,
                                                device=device)
            print(f"# radius={radius}, auprc={au}, rmse={rmse}, "
                  f"recall={recall}, targets={n}")

    if only_validate:
        report("Extraction complete")
        return

    def nms(score):
        if dims == 2:
            return non_maximum_suppression(score, radius, threshold=threshold, device=device)
        return non_maximum_suppression_3d(score, radius, threshold=threshold, device=device)

    def pick(path, picker, image):
        # a tomogram's picks need no kept score map
        if dims == 3 and picker is not None:
            return (path, *pick_volume(picker, image, radius, threshold))
        return (path, *nms(_score(picker, image, patch_size, device)))

    picks = (((path, *nms(scores[image_name(path)])) for path in paths) if targets is not None
             else (pick(*item) for item in images))
    _write_picks(picks, output, per_micrograph, suffix, out_format, scale, dims, verbose)
    report("Extraction complete")
