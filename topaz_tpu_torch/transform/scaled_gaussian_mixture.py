"""Multi-image Gaussian mixture with per-image intensity scale factors (port
of topaz_tpu/transform/scaled_gaussian_mixture.py:17-132, the reference's
topaz/transform/scaled_gaussian_mixture.py:5-179).

EM over several images: image i contributes x_i / scale_i to mixture
components shared by all images, and each scale is re-estimated in closed
form every iteration. No command uses it. The images and the EM run as
tensors on ``device``; the dtypes are the JAX package's (float32 images and
initial hard labels, float64 accumulators and parameters), so the two agree
to float32 summation order.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from topaz_tpu_torch.device import resolve_device
from topaz_tpu_torch.transfer import as_device_tensor


class ScaledGaussianMixture:
    def __init__(self, ncomponents: int = 2, scale_prior: float = 0.5,
                 tol: float = 1e-6, device="cuda"):
        self.device = resolve_device(device)
        self.ncomponents = ncomponents
        f64 = dict(dtype=torch.float64, device=self.device)
        self.weights = torch.ones(ncomponents, **f64) / ncomponents
        self.means = torch.zeros(ncomponents, **f64)
        self.variances = torch.ones(ncomponents, **f64)
        self.scale_prior = scale_prior
        self.tol = tol

    def fit(self, X: List[np.ndarray], niters: int = 100, random=np.random,
            verbose: bool = False):
        """EM fit. Returns (per-image scales, per-image posteriors) as
        tensors on the device. The initial hard labels are drawn with
        ``random.randint(0, K, size=...)`` image by image, as the JAX
        package draws them, so one ``RandomState`` gives both one start."""
        X = [as_device_tensor(x, self.device).reshape(-1) for x in X]
        K = self.ncomponents

        mus = torch.stack([x.mean() for x in X])
        scale = mus / mus.mean()

        probas = []
        for x in X:
            comp = torch.from_numpy(np.asarray(random.randint(0, K, size=tuple(x.shape))))
            p = torch.zeros((len(x), K), dtype=torch.float32, device=self.device)
            p[torch.arange(len(x), device=self.device), comp.to(self.device)] = 1.0
            probas.append(p)

        logp = -math.inf
        for it in range(niters):
            # M step: weighted moments of the scaled pixels over all images
            n = torch.zeros(K, dtype=torch.float64, device=self.device)
            sx = torch.zeros_like(n)
            sxx = torch.zeros_like(n)
            for i, (x, p) in enumerate(zip(X, probas)):
                xs = x / scale[i]
                n += p.sum(dim=0)
                sx += (p * xs[:, None]).sum(dim=0)
                sxx += (p * xs[:, None] ** 2).sum(dim=0)
            means = sx / n
            variances = (sxx - n * means ** 2) / n
            weights = (n + 1) / (n.sum() + K)

            # E step: the scales in closed form, then the responsibilities
            cur_logp = logp
            logp = 0.0
            for i, x in enumerate(X):
                p = probas[i]
                a = torch.sum(p * x[:, None] ** 2 / variances)
                b = torch.sum(p * x[:, None] * means / variances)
                scale[i] = 2 * a / (b + torch.sqrt(b ** 2 + 4 * a * len(x)))

                log_post = (-((x[:, None] / scale[i] - means) ** 2) / 2 / variances
                            - 0.5 * math.log(2 * math.pi)
                            - 0.5 * torch.log(variances)
                            + torch.log(weights))
                ma = log_post.max(dim=-1, keepdim=True).values
                log_post = log_post - ma
                logp += float(torch.sum(torch.log(torch.sum(torch.exp(log_post), dim=-1)))
                              + ma.sum())
                post = torch.exp(log_post)
                probas[i] = post / post.sum(dim=-1, keepdim=True)

            if verbose:
                print(f"# [{it}] logp={logp}")
            if logp - cur_logp < self.tol:
                break

        self.weights = weights
        self.means = means
        self.variances = variances
        return scale, probas

    def transform(self, X: List[np.ndarray], niters: int = 5):
        """Per-image scales under the fitted mixture, with a prior on not
        scaling (the reference's transform, scaled_gaussian_mixture.py:
        126-179). Returns (scales, last posteriors) as tensors."""
        X = [as_device_tensor(x, self.device) for x in X]
        means, variances, weights = self.means, self.variances, self.weights

        mus = torch.stack([x.mean() for x in X])
        scale = mus.mean() / mus

        def assign(x, s):
            p = torch.exp(-((x[..., None] / s - means) ** 2) / 2 / variances)
            p = p / torch.sqrt(2 * math.pi * variances) * weights
            return p.argmax(dim=-1)

        components = [assign(x, scale[i]) for i, x in enumerate(X)]

        proba = None
        for _ in range(niters):
            for i, x in enumerate(X):
                comp = components[i]
                mu = means[comp]
                var = variances[comp]
                a = torch.sum(x ** 2 / var)
                b = torch.sum(x * mu / var)
                scale[i] = a / b

                unscaled_logp = math.log(1 - self.scale_prior) - torch.sum(
                    (x - mu) ** 2 / 2 / var)
                scaled_logp = math.log(self.scale_prior) - torch.sum(
                    (x / scale[i] - mu) ** 2 / 2 / var)
                if unscaled_logp >= scaled_logp:
                    scale[i] = 1.0

                proba = torch.exp(-((x[..., None] / scale[i] - means) ** 2) / 2 / variances)
                proba = proba / torch.sqrt(2 * math.pi * variances) * weights
                components[i] = proba.argmax(dim=-1)

        return scale, proba
