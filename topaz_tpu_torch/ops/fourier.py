"""Fourier-crop downsampling and low-pass filtering (port of
topaz_tpu/ops/fourier.py).

``downsample`` reproduces topaz/utils/image.py:38-61 on ``torch.fft``: rfft2,
keep the low-frequency corner blocks, rescale by the area ratio, irfft2;
``downsample_3d`` does the same over the last three axes of a volume.
``downsample_numpy`` is its host twin on scipy's pocketfft. ``lowpass``
zeroes the coefficients above nyquist/factor (topaz/denoise.py:174-197) in
2D or 3D. These were XLA ops on the TPU; here they are cuFFT through
``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from topaz_tpu_torch.transfer import as_device_tensor


def _target_shape(x_shape, factor, shape):
    if shape is None:
        shape = (int(x_shape[-2] / factor), int(x_shape[-1] / factor))
    return int(shape[0]), int(shape[1])


def downsample(x, factor: float = 1, shape=None, device="cuda") -> torch.Tensor:
    """Downsample a 2D array (or batch of them) by Fourier cropping.

    Output shape is ``(int(H/factor), int(W/factor))`` unless ``shape`` is
    given. ``x`` is an array or tensor; the FFTs run on ``device``."""
    x = as_device_tensor(x, device)
    m, n = _target_shape(x.shape, factor, shape)
    F = torch.fft.rfft2(x)
    # keep the lowest m//2 positive-frequency rows and the top m - m//2
    # negative-frequency rows, and the first n//2+1 columns
    A = F[..., 0:m // 2, 0:n // 2 + 1]
    B = F[..., F.shape[-2] - (m - m // 2):, 0:n // 2 + 1]
    F = torch.cat([A, B], dim=-2)
    # energy rescale by the pixel-count ratio (image.py:54-57)
    F = F * ((n * m) / (x.shape[-2] * x.shape[-1]))
    return torch.fft.irfft2(F, s=(m, n))


def _crop_axis(F: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """The lowest ``size // 2`` and the top ``size - size // 2`` frequencies
    of axis ``dim``."""
    n = F.shape[dim]
    return torch.cat([F.narrow(dim, 0, size // 2),
                      F.narrow(dim, n - (size - size // 2), size - size // 2)], dim=dim)


def downsample_3d(x, factor: float = 1, shape=None, device="cuda") -> torch.Tensor:
    """Fourier-crop the last three axes of a volume (or a batch of them)
    to ``shape``, by default ``int(extent / factor)`` on each axis
    (topaz_tpu/ops/fourier.py:72-97). The FFTs run on ``device``."""
    x = as_device_tensor(x, device)
    if shape is None:
        shape = tuple(int(s / factor) for s in x.shape[-3:])
    d, m, n = (int(s) for s in shape)
    F = torch.fft.rfftn(x, dim=(-3, -2, -1))[..., 0:n // 2 + 1]
    F = _crop_axis(_crop_axis(F, m, -2), d, -3)
    F = F * ((d * m * n) / (x.shape[-3] * x.shape[-2] * x.shape[-1]))
    return torch.fft.irfftn(F, s=(d, m, n), dim=(-3, -2, -1))


def lowpass(x, factor: float = 1, dims: int = 2, device="cuda") -> torch.Tensor:
    """Low-pass filter the last ``dims`` axes: zero every Fourier
    coefficient whose frequency magnitude exceeds nyquist/factor along any
    of them. ``x`` is an array or tensor; the FFTs run on ``device``."""
    x = as_device_tensor(x, device)
    if factor == 1:
        return x
    shape = x.shape[-dims:]
    axes = tuple(range(-dims, 0))
    F = torch.fft.rfftn(x, dim=axes)
    cut = 0.5 / factor
    keep = torch.ones(F.shape[-dims:], dtype=torch.bool, device=x.device)
    for d, size in enumerate(shape):
        freq = (torch.fft.rfftfreq(size, device=x.device) if d == dims - 1
                else torch.fft.fftfreq(size, device=x.device))
        bshape = [1] * dims
        bshape[d] = -1
        keep = keep & (freq.abs() <= cut).reshape(bshape)
    return torch.fft.irfftn(torch.where(keep, F, 0), s=shape, dim=axes)


def downsample_numpy(x: np.ndarray, factor: float = 1, shape=None) -> np.ndarray:
    """Host twin of :func:`downsample` (same crop/rescale arithmetic,
    scipy's pocketfft, which keeps float32)."""
    from scipy.fft import irfft2, rfft2

    x = np.asarray(x, dtype=np.float32)
    m, n = _target_shape(x.shape, factor, shape)
    F = rfft2(x)
    A = F[..., 0:m // 2, 0:n // 2 + 1]
    B = F[..., F.shape[-2] - (m - m // 2):, 0:n // 2 + 1]
    F = np.concatenate([A, B], axis=-2)
    F *= (n * m) / (x.shape[-2] * x.shape[-1])
    return irfft2(F, s=(m, n)).astype(np.float32)
