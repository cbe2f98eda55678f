"""Validation against targets and 3D picking on the card against the same
on the CPU.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_extract_cuda.py``. Without a card it skips. The radius
search runs the disk-max kernel on both of its routes (r = 5 in shared
memory, r = 100 from device memory) on maps that stay on the card; its
AUPRC, recall and target count must equal the CPU's (the maps are the
inputs, so nothing but the filter differs, and max is exact). A 3D picker
scores a volume in tiles on the card within 1e-4 x max(1, |s|) of the CPU
(cuDNN and the CPU sum float32 in other orders), and the 3D picks of the
card's map equal the CPU's picks of the same map."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch.extract import extract_auprc
from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.models.factory import new_picker
from topaz_tpu_torch.models.tiling import classify_patches_3d
from topaz_tpu_torch.ops import disk_max as dm
from topaz_tpu_torch.ops import nms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the disk-max kernel and the 3D picker on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [5, 100])
def test_extract_auprc_on_the_card_equals_the_cpu(cuda_device, radius):
    rng = np.random.default_rng(radius)
    maps, rows = {}, []
    for i in range(3):
        x = rng.normal(-3, 1, size=(256, 300)).astype(np.float32)
        for _ in range(20):
            y, xx = int(rng.integers(0, 256)), int(rng.integers(0, 300))
            x[y, xx] = rng.uniform(2, 6)
            rows.append((f"m{i}", xx, y))
        maps[f"m{i}"] = x
    table = Coordinates.from_columns({"image_name": np.array([r[0] for r in rows], dtype=object),
                                      "x_coord": np.array([r[1] for r in rows]),
                                      "y_coord": np.array([r[2] for r in rows])})
    on_card = {k: torch.from_numpy(v).to(cuda_device) for k, v in maps.items()}
    dm.launches = nms.uploads = 0
    card = extract_auprc(table, on_card, radius, -2.0, device=cuda_device)
    assert dm.launches > 0 and nms.uploads == 0
    cpu = extract_auprc(table, {k: torch.from_numpy(v) for k, v in maps.items()}, radius, -2.0,
                        device="cpu")
    assert card == cpu


@pytest.mark.cuda
def test_3d_picker_tiles_and_picks_on_the_card_match_the_cpu(cuda_device):
    x = np.random.default_rng(1).normal(size=(40, 52, 60)).astype(np.float32)
    model = new_picker("resnet8", units=8, dims=3, seed=0, device="cpu")
    want = classify_patches_3d(model, x, patch_size=32, batch_size=2)
    dm.launches = 0
    got = classify_patches_3d(model.to(cuda_device), x, patch_size=32, batch_size=2)
    assert got.device.type == "cuda"
    err = ((got.cpu() - want).abs() / want.abs().clamp(min=1)).max().item()
    assert err <= 1e-4, err
    s_card, c_card = nms.non_maximum_suppression_3d(got, 3, threshold=0.0, device=cuda_device)
    s_cpu, c_cpu = nms.non_maximum_suppression_3d(got.cpu(), 3, threshold=0.0, device="cpu")
    np.testing.assert_array_equal(c_card, c_cpu)
    np.testing.assert_array_equal(s_card, s_cpu)
    assert dm.launches == 0
