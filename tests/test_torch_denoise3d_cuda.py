"""The 3D denoiser on the card against the same on the CPU: one training
step and one patched denoising.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_denoise3d_cuda.py``. Without a card it skips. The same
weights (drawn from a CPU generator) go to both devices. Tolerances: the
step's loss rtol 1e-4 and the weights after one sgd step (nesterov, so each
weight moves by 1.9 lr g) atol 1e-6, well above lr times the gradients'
float32 sum-order differences; the denoised volume 1e-3 x the input's std
(cuDNN, TF32 off, and the CPU sum float32 in other orders)."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch.denoise import Denoise3D, make_denoise_optimizer, make_denoise_step

LR = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the 3D denoiser on the card with the CPU")
    return torch.device("cuda")


def _step(device, src, tgt):
    den = Denoise3D.from_arch("unet", device=device, nf=8, base_width=7, seed=0)
    step = make_denoise_step(den.model, make_denoise_optimizer(den.model, "sgd", LR))
    loss = step(torch.from_numpy(src).to(device), torch.from_numpy(tgt).to(device), 2.0)
    return float(loss), {k: v.cpu() for k, v in den.model.state_dict().items()}


@pytest.mark.cuda
def test_3d_train_step_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    tgt = (src + rng.normal(size=src.shape)).astype(np.float32)
    got_loss, got = _step(cuda_device, src, tgt)
    want_loss, want = _step(torch.device("cpu"), src, tgt)
    assert torch.backends.cudnn.allow_tf32 is False
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [True, False])
def test_3d_patches_on_the_card_match_the_cpu(cuda_device, resident):
    vol = np.random.default_rng(1).normal(size=(40, 48, 44)).astype(np.float32)
    kw = dict(patch_size=24, padding=12, verbose=False, device_resident=resident,
              batch_size=2)
    den = {d: Denoise3D.from_arch("unet", device=d, nf=8, base_width=7, seed=1)
           for d in ("cpu", cuda_device)}
    want = den["cpu"].denoise(vol, **kw)
    got = den[cuda_device].denoise(vol, **kw)
    assert den[cuda_device].last_route == ("resident" if resident else "streaming")
    np.testing.assert_allclose(got, want, atol=1e-3 * vol.std(), rtol=0)
