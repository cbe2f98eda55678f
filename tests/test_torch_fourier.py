"""The port's Fourier-crop downsampling against the JAX package.

Same inputs (numpy, seeded) through ``topaz_tpu.ops.fourier.downsample`` and
``topaz_tpu_torch.ops.fourier.downsample`` on the CPU, and the same for the
3D ``downsample_3d`` and ``lowpass`` in 2D and 3D. Tolerance atol 1e-4,
rtol 1e-5 for the 2D crops, 1e-5 of the output's largest magnitude for the
3D functions and ``lowpass``: both are float32 FFTs whose sums run in
different orders."""

import numpy as np
import pytest
import torch

from topaz_tpu.ops import fourier as jfourier
from topaz_tpu_torch.ops import fourier as tfourier
from torch_threads import one_torch_thread  # noqa: F401

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


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,factor,target", [
    ((20, 30, 24), 2, None), ((33, 40, 27), 3, None), ((2, 16, 18, 20), None, (7, 9, 11))])
def test_downsample_3d_matches_jax(shape, factor, target):
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    want = np.asarray(jfourier.downsample_3d(x, factor or 1, shape=target))
    got = tfourier.downsample_3d(x, factor or 1, shape=target, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if target is None:
        assert want.shape == tuple(int(s / factor) for s in shape)
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,factor,dims", [
    ((20, 30, 24), 2, 3), ((17, 22, 31), 3.5, 3), ((2, 18, 20, 22), 2, 3),
    ((50, 64), 3, 2), ((2, 45, 38), 2, 2), ((20, 30, 24), 1, 3)])
def test_lowpass_matches_jax(shape, factor, dims):
    x = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    want = np.asarray(jfourier.lowpass(x, factor, dims))
    got = tfourier.lowpass(x, factor, dims=dims, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got.numpy(), want)
