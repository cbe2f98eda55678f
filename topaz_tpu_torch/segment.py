"""Dense score maps of images with a picker (port of topaz_tpu/segment.py,
the reference's topaz/model/utils.py:71-105).

Each image is scored on the device, whole (as ``extract`` scores it) or in
tiles of twice ``patch_size`` (the reference's own rule for this command),
and the map is written beside the others: ``<name>.tiff`` for a 2D image
(PIL, imported only here), ``<name>.npy`` for a 3D volume.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.io.image import load_image
from topaz_tpu_torch.utils.printing import report


def score_maps(model: str, paths: List[str], patch_size: Optional[int] = None,
               device="cuda") -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (path, float32 score map on the host) for each image: the
    dense picker over the whole image, or ``predict_in_patches`` (3D:
    ``classify_patches_3d``) with tiles of ``2 * patch_size``
    (topaz_tpu/segment.py:59-75)."""
    from topaz_tpu_torch.models.factory import load_picker
    from topaz_tpu_torch.models.tiling import classify_patches_3d, predict_in_patches

    device = resolve_device(device)
    picker = load_picker(model, device=device)
    for path in paths:
        image = np.array(load_image(path), dtype=np.float32)
        if image.ndim != picker.spec.dims:
            raise ValueError(f"{path}: a {image.ndim}D image for a {picker.spec.dims}D picker")
        if patch_size is not None:
            tile = classify_patches_3d if image.ndim == 3 else predict_in_patches
            score = tile(picker, image, patch_size * 2)
        else:
            with torch.inference_mode():
                score = picker(torch.from_numpy(image).to(device)[None])[0]
        yield path, score.cpu().numpy()


def segment_images(model: str, paths: List[str], output_dir: str,
                   patch_size: Optional[int] = None, verbose: bool = False,
                   device="cuda") -> None:
    """Score ``paths`` with the picker ``model`` and write each dense score
    map into ``output_dir`` (topaz_tpu/segment.py:14-90)."""
    os.makedirs(output_dir, exist_ok=True)
    for path, score in score_maps(model, paths, patch_size=patch_size, device=device):
        out = os.path.join(output_dir, os.path.splitext(os.path.basename(path))[0])
        if verbose:
            report("saving:", out)
        if score.ndim == 3:
            np.save(out + ".npy", score)
        else:
            from PIL import Image

            Image.fromarray(score).save(out + ".tiff", "tiff")
