"""The port's Fourier-crop downsampling against the JAX package.

Same inputs (numpy, seeded) through ``topaz_tpu.ops.fourier.downsample`` and
``topaz_tpu_torch.ops.fourier.downsample`` on the CPU. Tolerance atol 1e-4,
rtol 1e-5: both are float32 FFTs whose sums run in different orders."""

import numpy as np
import pytest
import torch

from topaz_tpu.ops import fourier as jfourier
from topaz_tpu_torch.ops import fourier as tfourier

CASES = [((512, 512), 8), ((257, 300), 3), ((100, 64), 2)]


def _image(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,factor", CASES)
def test_downsample_matches_jax(shape, factor):
    x = _image(shape, seed=factor)
    want = np.asarray(jfourier.downsample(x, factor))
    got = tfourier.downsample(x, factor, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (int(shape[0] / factor), int(shape[1] / factor))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,factor", CASES)
def test_downsample_numpy_matches_jax_twin(shape, factor):
    x = _image(shape, seed=factor + 1)
    np.testing.assert_allclose(tfourier.downsample_numpy(x, factor),
                               jfourier.downsample_numpy(x, factor),
                               atol=1e-4, rtol=1e-5)


def test_downsample_batched_and_explicit_shape():
    x = _image((2, 90, 75), seed=5)
    want = np.asarray(jfourier.downsample(x, shape=(31, 24)))
    got = tfourier.downsample(torch.from_numpy(x), shape=(31, 24), device="cpu")
    assert tuple(got.shape) == (2, 31, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_downsample_file_matches_jax(tmp_path):
    from topaz_tpu.io import image as jimage
    from topaz_tpu_torch.io import image as timage
    from topaz_tpu_torch.io import mrc

    src = str(tmp_path / "a.mrc")
    mrc.write(src, _image((96, 80), seed=9))
    jimage.downsample_file(src, 4, str(tmp_path / "j.mrc"))
    timage.downsample_file(src, 4, str(tmp_path / "t.mrc"), device="cpu")
    want, wheader, _ = mrc.read(str(tmp_path / "j.mrc"))
    got, gheader, _ = mrc.read(str(tmp_path / "t.mrc"))
    assert got.shape == (24, 20)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    assert gheader == wheader
