"""3D and autoencoder training steps on the card against the CPU.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_train3d_cuda.py``. Without a card its tests skip. The same
weights (drawn from CPU generators), crops and labels go through three Adam
steps on each device; the metrics of each step agree to rtol 1e-3, atol
1e-5 (cuDNN and the CPU sum float32 in other orders; TF32 is off), as in
``test_torch_train_cuda.py``. The 3D step's crops are of the receptive
field: oversized ones are augmented from each device's own generator, whose
streams differ. So the third test holds the windows cut on the card from
the resident tomogram against the host gather, and runs the augmenting 3D
step on them for finite metrics."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.models.factory import new_picker
from topaz_tpu_torch.models.generative import init_generator
from topaz_tpu_torch.train.data import CropSampler, ResidentVolumes
from topaz_tpu_torch.train.methods import make_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step

LR = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the train step on the card")
    return torch.device("cuda")


def _run(device, crops, labels, arch, units, dims, autoencoder=0.0):
    model = new_picker(arch, units=units, dims=dims, seed=0, device=device)
    decoder = None
    if autoencoder:
        decoder = init_generator(model.spec.latent_dim, torch.Generator().manual_seed(1),
                                 units=8, depth=3).to(device)
    state = init_train_state(model, 0.05, lr=LR, seed=0, decoder=decoder)
    loss_fn, header, _ = make_loss_fn("GE-binomial", 0.05)
    if autoencoder:
        header = header + ["recon_error"]
    step = make_train_step(loss_fn, autoencoder=autoencoder)
    rows = []
    for c, y in zip(crops, labels):
        m = step(state, torch.from_numpy(c).to(device), torch.from_numpy(y).to(device))
        rows.append([float(m[h]) for h in header if h != "adjusted_precision"])
    return np.array(rows)


@pytest.mark.cuda
def test_3d_train_steps_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    crops = rng.normal(size=(3, 16, 31, 31, 31)).astype(np.float32)
    labels = (rng.random((3, 16)) < 0.2).astype(np.float32)
    got = _run(cuda_device, crops, labels, "conv31", 16, 3)
    want = _run(torch.device("cpu"), crops, labels, "conv31", 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_autoencoder_train_steps_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(1)
    crops = (rng.normal(size=(3, 32, 71, 71))
             + 2 * rng.normal(size=(3, 32, 1, 1))).astype(np.float32)
    labels = (rng.random((3, 32)) < 0.2).astype(np.float32)
    got = _run(cuda_device, crops, labels, "resnet8", 32, 2, autoencoder=1.0)
    want = _run(torch.device("cpu"), crops, labels, "resnet8", 32, 2, autoencoder=1.0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_3d_windows_cut_on_the_card_equal_the_host_gather(cuda_device, tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "tomo.mrc")
    mrc.write(path, rng.normal(size=(40, 64, 72)).astype(np.float32))
    targets = Coordinates(np.array(["tomo"] * 5, dtype=object), rng.integers(0, 72, 5),
                          rng.integers(0, 64, 5), z_coord=rng.integers(0, 40, 5))
    host = CropSampler([path], targets, 31, rotate=True, seed=3, dims=3)
    card = CropSampler([path], targets, 31, rotate=True, seed=3, dims=3)
    volumes = ResidentVolumes(card, cuda_device)
    for n_pos in (0, 4, 16):
        want, _ = host.sample_batch(16, n_pos)
        *where, _ = card.sample_positions(16, n_pos)
        got = volumes.gather(*where)
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    # the augmenting 3D step on the card: finite metrics
    model = new_picker("conv31", units=8, dims=3, seed=0, device=cuda_device)
    state = init_train_state(model, 0.05, lr=LR, seed=0)
    step = make_train_step(make_loss_fn("GE-binomial", 0.05)[0])
    metrics = step(state, got, torch.from_numpy((np.arange(16) < 4).astype(np.float32)).cuda())
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
