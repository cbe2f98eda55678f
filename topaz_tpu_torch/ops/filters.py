"""Classical image filters: Gaussian, inverse-Gaussian and the whitening
("unblur") deconvolution filter estimated from the image's own
autocovariance (port of topaz_tpu/ops/filters.py:20-162, the
reference's topaz/filters.py and topaz/denoise.py:22-172).

Kernels are built on the host in numpy; images are 2D tensors (volumes 3D
for ``apply_kernel``) and every filter runs on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from topaz_tpu_torch.transfer import as_device_tensor


def gaussian_filter(sigma: float, s: int = 11, dims: int = 2) -> np.ndarray:
    """Unnormalized Gaussian kernel (topaz/filters.py:6-19)."""
    dim = s // 2
    r = np.arange(-dim, dim + 1)
    if dims == 2:
        d = r[:, None] ** 2 + r[None, :] ** 2
    else:
        d = r[:, None, None] ** 2 + r[None, :, None] ** 2 + r[None, None, :] ** 2
    return np.exp(-0.5 * d / sigma**2)


def inverse_filter(w: np.ndarray) -> np.ndarray:
    """Spatial kernel of the Fourier inverse of w (topaz/filters.py:22-25)."""
    Fw = np.fft.rfft2(np.fft.ifftshift(w))
    return np.fft.fftshift(np.fft.irfft2(1 / Fw, s=w.shape))


def apply_kernel(x, w, device="cuda", dims: int = 2) -> torch.Tensor:
    """SAME-correlate one 2D image, or with ``dims=3`` one volume, with a
    dense kernel of as many axes (AffineFilter/GaussianDenoise.apply
    semantics, topaz/filters.py:28-80). SAME pads (k-1)//2 before and k//2
    after each axis, as XLA does."""
    x = as_device_tensor(x, device)
    w = torch.as_tensor(np.asarray(w, dtype=np.float32), device=x.device)
    if x.ndim != dims or w.ndim != dims:
        raise ValueError(f"apply_kernel(dims={dims}) got a {x.ndim}D input and a "
                         f"{w.ndim}D kernel")
    pad = []
    for k in reversed(w.shape):  # F.pad lists the last axis first
        pad += [(k - 1) // 2, k // 2]
    conv = F.conv2d if dims == 2 else F.conv3d
    return conv(F.pad(x[None, None], pad), w[None, None])[0, 0]


def gaussian_denoise_kernel(sigma: float, scale: int = 5, dims: int = 2) -> np.ndarray:
    """Normalized truncated Gaussian (topaz/filters.py:51-66)."""
    width = 1 + 2 * int(np.ceil(sigma * scale))
    f = gaussian_filter(sigma, s=width, dims=dims)
    return (f / f.sum()).astype(np.float32)


def inv_gaussian_kernel(sigma: float, scale: int = 5) -> np.ndarray:
    """Inverse of the normalized Gaussian (topaz/filters.py:83-96)."""
    f = gaussian_denoise_kernel(sigma, scale=scale, dims=2)
    return inverse_filter(f).astype(np.float32)


def spatial_covariance(x, n: int = 11, device="cuda") -> torch.Tensor:
    """Autocovariance of x over an n x n window (topaz/denoise.py:22-49):
    the VALID correlation of the image with its own centre crop, computed
    as the n * n shifted elementwise-product sums, since as a convolution
    the crop would be an (H - n + 1) x (W - n + 1) filter."""
    x = as_device_tensor(x, device)
    p = n // 2
    H, W = x.shape
    xc = x[p:H - p, p:W - p]
    h, w = xc.shape
    cov = torch.stack([torch.stack([(x[i:i + h, j:j + w] * xc).sum() for j in range(n)])
                       for i in range(n)])
    return cov / (h * w)


def estimate_unblur_filter(x, width: int = 11, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Whitening filter that flattens the autocovariance power spectrum
    (topaz/denoise.py:52-75). Returns (kernel, covariance) as numpy."""
    cov = spatial_covariance(x, n=width, device=device).cpu().numpy()
    ps = np.fft.fft2(np.fft.ifftshift(cov))
    re = ps.real.copy()
    re[re <= 0] = 1
    re[0, 0] = 1
    w_inv = np.fft.fftshift(np.fft.ifft2(1 / np.sqrt(re))).real
    return w_inv.astype(np.float32), cov


def estimate_unblur_filter_gaussian(x, width: int = 11, s: int = 11, device="cuda"):
    """The Gaussian-parameterized whitening filter (topaz/denoise.py:77-127,
    topaz_tpu/ops/filters.py:90-130; dead code upstream, no command calls
    it): fit (sigma, alpha) in log space so that the Gaussian kernel
    correlated with itself best matches the autocovariance, then return the
    inverse of that filter. The loss and its gradient (autograd) run on
    ``device``; the 2-parameter BFGS runs on the host (scipy). Returns
    (inverse kernel, sigma, alpha, covariance)."""
    from scipy.optimize import minimize

    cov = spatial_covariance(x, n=width, device=device)
    dim = s // 2
    r = torch.arange(-dim, dim + 1, device=cov.device)
    d = (r[:, None] ** 2 + r[None, :] ** 2).to(torch.float32)
    p = width // 2

    def fun(params):
        t = torch.tensor(params, dtype=torch.float32, device=cov.device, requires_grad=True)
        sigma, alpha = torch.exp(t[0]), torch.exp(t[1])
        w = alpha * torch.exp(-0.5 * d / sigma ** 2)
        c_w = F.conv2d(w[None, None], w[None, None], padding=p)[0, 0]
        loss = torch.sum((c_w - cov) ** 2)
        loss.backward()
        return float(loss.detach()), t.grad.cpu().numpy().astype(np.float64)

    result = minimize(fun, np.zeros(2), jac=True)
    sigma = float(np.exp(result.x[0]))
    alpha = float(np.exp(result.x[1]))
    w_inv = inverse_filter(gaussian_filter(sigma, s=s) * alpha)
    return w_inv.astype(np.float32), sigma, alpha, cov.cpu().numpy()


def correct_spatial_covariance(x, width: int = 11, patch: int = 1,
                               device="cuda") -> torch.Tensor:
    """Estimate the whitening filter and apply it, optionally on a
    ``patch`` x ``patch`` grid of tiles, each with a ``width // 2`` apron
    (topaz/denoise.py:129-172)."""
    x = as_device_tensor(x, device)
    if patch <= 1:
        w, _ = estimate_unblur_filter(x, width=width, device=x.device)
        return apply_kernel(x, w, device=x.device)
    H, W = x.shape
    rows = [H // patch + (k < H % patch) for k in range(patch)]
    cols = [W // patch + (k < W % patch) for k in range(patch)]
    y = torch.empty_like(x)
    a = width // 2
    i = 0
    for n in rows:
        j = 0
        for m in cols:
            i0, j0 = max(0, i - a), max(0, j - a)
            y_ij = correct_spatial_covariance(
                x[i0:min(H, i + n + a), j0:min(W, j + m + a)], width=width, device=x.device)
            y[i:i + n, j:j + m] = y_ij[i - i0:i - i0 + n, j - j0:j - j0 + m]
            j += m
        i += n
    return y
