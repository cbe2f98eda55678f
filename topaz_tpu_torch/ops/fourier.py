"""Fourier-crop downsampling and low-pass filtering (port of
topaz_tpu/ops/fourier.py:19-68,100-122).

``downsample`` reproduces topaz/utils/image.py:38-61 on ``torch.fft``: rfft2,
keep the low-frequency corner blocks, rescale by the area ratio, irfft2.
``downsample_numpy`` is its host twin on scipy's pocketfft. ``lowpass``
zeroes the coefficients above nyquist/factor (topaz/denoise.py:174-197).
"""

from __future__ import annotations

import numpy as np
import torch

from topaz_tpu_torch.device import as_device_tensor


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


def lowpass(x, factor: float = 1, device="cuda") -> torch.Tensor:
    """Low-pass filter the last two axes: zero every Fourier coefficient
    whose frequency magnitude exceeds nyquist/factor along either axis.
    ``x`` is an array or tensor; the FFTs run on ``device``."""
    x = as_device_tensor(x, device)
    if factor == 1:
        return x
    H, W = x.shape[-2:]
    F = torch.fft.rfft2(x)
    cut = 0.5 / factor
    keep = ((torch.fft.fftfreq(H, device=x.device).abs() <= cut)[:, None]
            & (torch.fft.rfftfreq(W, device=x.device).abs() <= cut)[None, :])
    return torch.fft.irfft2(torch.where(keep, F, 0), s=(H, W))


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
