"""The U-Net on the card against the same module on the CPU.

This file imports no JAX, so that it runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_denoise_cuda.py``. Without a card it skips. Tolerance
1e-3 * std of the CPU output: cuDNN (TF32 off) and the CPU sum float32 in
other orders."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch.denoise import Denoise
from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the U-Net on the card with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("patch_size,padding", [(-1, 0), (192, 64)])
def test_unet_on_the_card_matches_the_cpu(cuda_device, patch_size, padding):
    x, _ = make_ctf_micrograph(np.random.default_rng(0), size=512, n_particles=1)
    want = Denoise("unet", device="cpu").denoise(x, patch_size, padding).numpy()
    got = Denoise("unet", device=cuda_device).denoise(x, patch_size, padding).cpu().numpy()
    assert torch.backends.cudnn.allow_tf32 is False
    np.testing.assert_allclose(got, want, atol=1e-3 * want.std(), rtol=0)
