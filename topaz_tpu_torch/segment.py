"""Dense score maps of images with a picker (port of topaz_tpu/segment.py,
the reference's topaz/model/utils.py:71-105).

Each image is scored on the device, whole (as ``extract`` scores it) or in
tiles of twice ``patch_size`` (the reference's own rule for this command),
and the map is written beside the others: ``<name>.tiff`` for a 2D image
(PIL, imported only here), ``<name>.npy`` for a 3D volume. With several
``devices`` (``-d -2``) a whole 2D image is scored with its rows split over
them (halo scoring, parallel/mesh.make_halo_dense_scorer).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from topaz_tpu_torch.parallel.devices import resolve_devices, space_mesh_for
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.utils.printing import report


def score_maps(model: str, paths: List[str], patch_size: Optional[int] = None,
               device="cuda", devices=None) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (path, float32 score map on the host) for each image: the
    dense picker over the whole image, or ``predict_in_patches`` (3D:
    ``classify_patches_3d``) with tiles of ``2 * patch_size``
    (topaz_tpu/segment.py:59-75). ``devices`` (default: ``device``'s)
    of two or more split whole 2D images by rows over them, as many shards
    as hold the receptive field's half (topaz_tpu/segment.py:39-56)."""
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.models.tiling import classify_patches_3d, predict_in_patches
    from topaz_tpu_torch.parallel.mesh import make_halo_dense_scorer, make_mesh

    devices = list(devices) if devices else resolve_devices(device)
    device = devices[0]
    picker = load_picker(model, device=device)
    mesh = space_mesh_for(devices)
    halo_fns = {}

    def score_halo(image: np.ndarray):
        halo = picker.spec.width // 2
        n = min(mesh.shape["space"], max(1, image.shape[0] // max(halo, 1)))
        if n < 2:
            return None
        pad = (-image.shape[0]) % n
        xp = np.pad(image, ((0, pad), (0, 0))) if pad else image
        if n not in halo_fns:
            halo_fns[n] = make_halo_dense_scorer(
                picker, make_mesh(n_data=1, n_space=n, devices=devices[:n]))
        return halo_fns[n](xp)[: image.shape[0]]

    for path in paths:
        image = np.array(load_image(path), dtype=np.float32)
        if image.ndim != picker.spec.dims:
            raise ValueError(f"{path}: a {image.ndim}D image for a {picker.spec.dims}D picker")
        if patch_size is not None:
            tile = classify_patches_3d if image.ndim == 3 else predict_in_patches
            score = tile(picker, image, patch_size * 2)
        else:
            score = score_halo(image) if image.ndim == 2 and mesh is not None else None
            if score is None:
                with torch.inference_mode():
                    score = picker(torch.from_numpy(image).to(device)[None])[0]
        yield path, score.cpu().numpy()


def segment_images(model: str, paths: List[str], output_dir: str,
                   patch_size: Optional[int] = None, verbose: bool = False,
                   device="cuda", devices=None) -> None:
    """Score ``paths`` with the picker ``model`` and write each dense score
    map into ``output_dir`` (topaz_tpu/segment.py:14-90)."""
    os.makedirs(output_dir, exist_ok=True)
    for path, score in score_maps(model, paths, patch_size=patch_size, device=device,
                                  devices=devices):
        out = os.path.join(output_dir, os.path.splitext(os.path.basename(path))[0])
        if verbose:
            report("saving:", out)
        if score.ndim == 3:
            np.save(out + ".npy", score)
        else:
            from PIL import Image

            Image.fromarray(score).save(out + ".tiff", "tiff")
