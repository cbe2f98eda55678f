"""Fourier-crop downsampling and two-component GMM normalization
(topaz/utils/image.py downsample; topaz/stats.py norm_fit and gmm_fit).

The EM runs every initial pi as its own lane with the reference's early
exit: a lane that gains no more than ``tol`` in log-likelihood stops and
keeps its state. Each pixel's terms are float32; every sum over pixels is
accumulated in float64 and rounded to float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def fourier_crop(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W) -> (..., int(H / factor), int(W / factor)): keep the
    lowest frequencies of the real FFT, rescale by the pixel-count ratio,
    invert; in float32, the configurations' precision. (The GMM's lanes
    of pi 0.8-0.98 end within a few units of log-likelihood of each other,
    so a crop in float64, which moves pixels by ~2e-6 of their spread, can
    select another lane and move scores by up to ~5e-3.)"""
    H, W = x.shape[-2:]
    m, n = int(H / factor), int(W / factor)
    F = torch.fft.rfft2(x.float())
    F = torch.cat([F[..., : m // 2, : n // 2 + 1], F[..., H - (m - m // 2):, : n // 2 + 1]], dim=-2)
    return torch.fft.irfft2(F * (m * n / (H * W)), s=(m, n))


def _sum(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(t, dim=-1, keepdim=True, dtype=torch.float64).float()


def _betaln(a: float, b: float) -> float:
    return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)


def _beta_logpdf(pi: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    out = torch.zeros_like(pi)
    if alpha != 1:
        out = out + (alpha - 1) * torch.log(pi)
    if beta != 1:
        out = out + (beta - 1) * torch.log1p(-pi)
    return out - _betaln(alpha, beta)


def gmm_em(x: torch.Tensor, pis: Sequence[float], splits: torch.Tensor, alpha: float,
           beta: float, num_iters: int):
    """EM of a shared-variance two-component GMM with a Beta(alpha, beta)
    prior on pi, one lane per initial pi, every lane run for ``num_iters``
    steps. ``x`` (B, N) float32, ``splits`` (B, L). Returns the state after
    each step k = 0 (the initialization) .. num_iters, as {logp, mu1, var}:
    (num_iters + 1, B, L) each. A lane's early exit is read off it by
    ``stops``: the lanes are independent, so stopping one changes no other."""
    B, N = x.shape
    n = float(N)
    X = x[:, None, :]
    pi = torch.tensor(list(pis), dtype=torch.float32, device=x.device).expand(B, -1)[..., None]
    mu_all = _sum(x)[:, None]

    def stats(p0, p1, pi):
        s0, s1 = _sum(p0), _sum(p1)
        mu0 = torch.where(s0 > 0, _sum(X * p0) / torch.where(s0 > 0, s0, 1), mu_all)
        mu1 = torch.where(s1 > 0, _sum(X * p1) / torch.where(s1 > 0, s1, 1), mu_all)
        var = _sum(p0 * (X - mu0) ** 2 + p1 * (X - mu1) ** 2) / n
        c = 0.5 * torch.log(2 * math.pi * var)
        lp0 = -((X - mu0) ** 2) / 2 / var - c + torch.log1p(-pi)
        lp1 = -((X - mu1) ** 2) / 2 / var - c + torch.log(pi)
        top = torch.maximum(lp0, lp1)
        Z = top + torch.log(torch.exp(lp0 - top) + torch.exp(lp1 - top))
        logp = _sum(Z) + _beta_logpdf(pi, alpha, beta)
        return lp0, lp1, Z, {"logp": logp, "mu1": mu1, "var": var}

    p0 = (X <= splits[..., None]).float()
    lp0, lp1, Z, state = stats(p0, 1 - p0, pi)
    history = [state]
    for _ in range(num_iters):
        p0, p1 = torch.exp(lp0 - Z), torch.exp(lp1 - Z)
        s1 = _sum(p1)
        a, b = alpha + s1, beta + n - s1
        lp0, lp1, Z, state = stats(p0, p1, (a - 1) / (a + b - 2))
        history.append(state)
    return {k: torch.stack([h[k][..., 0] for h in history]) for k in history[0]}


def stops(logp: torch.Tensor, tol: float) -> torch.Tensor:
    """The step each lane of a (K + 1, ...) log-likelihood history stops
    at under the reference's early exit: the first step that gains no more
    than ``tol``, else the last."""
    K = logp.shape[0] - 1
    ends = (logp[1:] - logp[:-1]) <= tol
    k = torch.arange(1, K + 1, device=logp.device).reshape((K,) + (1,) * (logp.dim() - 1))
    return torch.where(ends, k, K + 1).amin(dim=0).clamp(max=K)


def norm_fit(x: torch.Tensor, pis: Sequence[float], alpha: float, beta: float, tol: float,
             num_iters: int, settle_units: float = 4.0,
             slack_units: float = 64.0):
    """The best of the EM lanes (every pi but the last, 1.0) and the
    single-component model, by log-likelihood (topaz/stats.py norm_fit).
    ``x`` (B, N) float32. Returns (mu, std), each (B,), of the chosen fit's
    high-intensity component, the EM steps each lane took (B, L), and for
    each image the fits float32 arithmetic admits, as (mu, std) tensors
    (C_b,) with the chosen fit first.

    The early exit compares a gain with ``tol`` = 1e-3, below a float32
    log-likelihood's resolution (|logp| * 2^-23 is 0.008 at 6.5e4), so once
    a lane's true gain a step has fallen to a few of those, the step it
    stops at follows the order of its sums: on the card a lane of pi 0.9
    has stopped 10-25 steps before this reference, up to 46 such units
    below it. A fit is admitted where it is the state of a lane from the
    first step that gains no more than ``tol`` plus ``settle_units`` units
    onward, or the single-component model, and its log-likelihood is
    within ``slack_units`` units of the chosen fit's."""
    B, N = x.shape
    q = (1 - torch.tensor(list(pis), dtype=torch.float32, device=x.device)) * (N - 1)
    lo, hi = torch.floor(q), torch.ceil(q)
    xs = torch.sort(x, dim=-1).values
    frac = q - lo
    splits = xs[:, lo.long()] * (1 - frac) + xs[:, hi.long()] * frac
    hist = gmm_em(x, pis[:-1], splits[:, :-1], alpha, beta, num_iters)
    steps = stops(hist["logp"], tol)
    final = {k: v.gather(0, steps[None]).squeeze(0) for k, v in hist.items()}
    # the single-component lane: unbiased variance, and the prior's density
    # at pi = 1 (not its log), as topaz/stats.py adds it
    x64 = x.double()
    mu1c = x64.mean(-1)
    var1c = ((x64 - mu1c[:, None]) ** 2).sum(-1) / (N - 1)
    z1c = (-((x64 - mu1c[:, None]) ** 2) / 2 / var1c[:, None]
           - 0.5 * torch.log(2 * math.pi * var1c[:, None])).sum(-1)
    pdf1 = 0.0 if beta > 1 else (alpha if beta == 1 else math.inf)
    logp1c = (z1c + pdf1).float()
    logps = torch.cat([final["logp"], logp1c[:, None]], dim=-1)
    mus = torch.cat([final["mu1"], mu1c.float()[:, None]], dim=-1)
    stds = torch.sqrt(torch.cat([final["var"], var1c.float()[:, None]], dim=-1))
    i = torch.argmax(logps, dim=-1, keepdim=True)
    mu, std = mus.gather(-1, i)[:, 0], stds.gather(-1, i)[:, 0]
    # a constant frame normalizes to zeros (the port's documented guard)
    dead = (x.amax(-1) - x.amin(-1) <= 0) | ~torch.isfinite(std) | (std <= 0)
    mu = torch.where(dead, x.mean(-1), mu)
    std = torch.where(dead, torch.ones_like(std), std)

    best = logps.gather(-1, i)[:, 0]
    ulp = torch.abs(best) * 2.0 ** -23
    gains = hist["logp"][1:] - hist["logp"][:-1]
    K = gains.shape[0]
    k = torch.arange(1, K + 1, device=x.device)[:, None, None]
    settled = torch.where(gains <= tol + settle_units * ulp[None, :, None], k, K + 1).amin(0).clamp(max=K)
    admitted = []
    for b in range(B):
        ok = (torch.arange(K + 1, device=x.device)[:, None] >= settled[b][None]) & (
            hist["logp"][:, b] >= best[b] - slack_units * ulp[b])
        cand_mu = [mu[b:b + 1], hist["mu1"][:, b][ok]]
        cand_std = [std[b:b + 1], torch.sqrt(hist["var"][:, b][ok])]
        if not bool(dead[b]) and bool(logp1c[b] >= best[b] - slack_units * ulp[b]):
            cand_mu.append(mu1c[b:b + 1].float())
            cand_std.append(torch.sqrt(var1c[b:b + 1]).float())
        admitted.append((torch.cat(cand_mu), torch.cat(cand_std)))
    return mu, std, steps, admitted
