"""Overlap-tiled dense scoring for images and volumes too large for one
pass (port of topaz_tpu/models/tiling.py:58-123).

The dense (filled) picker is shift-equivariant, so scoring uniform tiles
with a receptive-field halo is exactly whole-image scoring. The image is
zero-padded up to a multiple of the tile plus the ``width // 2`` halo on
each side; tiles go to the picker's device in batches of ``batch_size``
(capped at the number of tiles), the ragged last batch padded by repeating
its last window, and the score map is assembled on that device, so it stays
there for the NMS rounds. The weights never leave the device.

Each batch of a volume records ``extract3d/tile`` (its windows cut on the
host and uploaded) and ``extract3d/score`` (the picker's forward and the
tiles written into the map) stage spans; 2D tiling records none. Every call
counts its tiles and the voxels of the windows through the picker in this
module's counters.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from topaz_tpu_torch.models.picker import Picker
from topaz_tpu_torch.utils.profiling import stage

# tiled scoring's work in this process: tiles scored, and voxels of the
# windows through the picker (a ragged last batch's fill copies too);
# callers may reset each to 0
tiles_scored = 0
network_voxels = 0


def _stage(dims: int, name: str, device=None):
    return stage(f"extract3d/{name}", device=device) if dims == 3 else contextlib.nullcontext()


def _tiled_scores(model: Picker, image: np.ndarray, tile: int,
                  batch_size: int = 4) -> torch.Tensor:
    global tiles_scored, network_voxels
    device = model.classifier_w.device
    dims = image.ndim
    pad = model.spec.width // 2
    shape = image.shape
    steps = [int(math.ceil(s / tile)) for s in shape]
    padded = np.pad(np.asarray(image, dtype=np.float32),
                    [(pad, pad + n * tile - s) for n, s in zip(steps, shape)])
    win = tile + 2 * pad
    origins = list(np.ndindex(*steps))
    batch_size = min(batch_size, len(origins))
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.inference_mode():
        for start in range(0, len(origins), batch_size):
            chunk = origins[start:start + batch_size]
            windows = chunk + [chunk[-1]] * (batch_size - len(chunk))
            with _stage(dims, "tile", device):
                tiles = np.stack([padded[tuple(slice(o * tile, o * tile + win) for o in origin)]
                                  for origin in windows])
                tiles = torch.from_numpy(tiles).to(device)
            with _stage(dims, "score", device):
                scores = model(tiles, pad=False)
                for origin, s in zip(chunk, scores):
                    dst = tuple(slice(o * tile, min((o + 1) * tile, n))
                                for o, n in zip(origin, shape))
                    out[dst] = s[tuple(slice(0, d.stop - d.start) for d in dst)]
    tiles_scored += len(origins)
    network_voxels += -(-len(origins) // batch_size) * batch_size * win ** dims
    return out


def predict_in_patches(model: Picker, image: np.ndarray, patch_size: int,
                       batch_size: int = 4) -> torch.Tensor:
    """2D tiled dense scoring of an (H, W) image on the picker's device;
    the result equals whole-image dense scoring (contract of
    topaz/model/utils.py:110-130)."""
    return _tiled_scores(model, image, int(patch_size), batch_size=batch_size)


def classify_patches_3d(model: Picker, volume: np.ndarray, patch_size: int = 96,
                        batch_size: int = 1) -> torch.Tensor:
    """3D tiled dense scoring of a (D, H, W) volume on the picker's device
    (contract of topaz/model/classifier.py:69-103)."""
    return _tiled_scores(model, volume, int(patch_size), batch_size=batch_size)
