"""Two-component GMM intensity normalization (port of
topaz_tpu/ops/gmm.py:30-426).

The EM procedure of topaz/stats.py:36-214: the 11 two-component lanes (one
per initial pi, ``DEFAULT_PIS[:-1]``) run as one (11, N) batch. Each lane
keeps the reference's early exit: a per-lane ``running`` mask is computed
before every EM step and a lane that is done, or out of iterations, keeps
its state, which is exactly what the JAX package's vmapped ``while_loop``
does. The loop ends when no lane runs, checked on the host once a step.

Numerical contract: same update equations, same init (quantile split,
shared variance), same MAP pi update, same termination; float32 reduction
order differs, so mu/std agree to ~1e-5 relative.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DEFAULT_PIS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98, 1.0)


def _betaln(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """log B(alpha, beta), evaluated in float64 (lgamma differences lose
    digits in float32 at alpha=900)."""
    a, b = alpha.double(), beta.double()
    return (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)).to(alpha.dtype)


def beta_logpdf(pi, alpha, beta) -> torch.Tensor:
    """log Beta(alpha, beta) density at pi (stats.py:165 prior term).

    The boundary cases follow scipy (finite at pi=1 when beta==1 and at
    pi=0 when alpha==1): the naive ``0 * log(0) = NaN`` would poison an EM
    lane whose MAP pi collapses to exactly 1.0."""
    pi = torch.as_tensor(pi, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=pi.dtype, device=pi.device)
    beta = torch.as_tensor(beta, dtype=pi.dtype, device=pi.device)
    zero = torch.zeros((), dtype=pi.dtype, device=pi.device)
    t_a = torch.where(alpha == 1, zero, (alpha - 1) * torch.log(pi))
    t_b = torch.where(beta == 1, zero, (beta - 1) * torch.log1p(-pi))
    return t_a + t_b - _betaln(alpha, beta)


def _beta_pdf_at_one(alpha, beta) -> torch.Tensor:
    """scipy.stats.beta.pdf(1, alpha, beta): 0 for beta>1, alpha for beta==1,
    inf for beta<1. The reference adds this (not its log!) to the
    single-component logp (stats.py:107) - reproduced for parity."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    beta = torch.as_tensor(beta, dtype=torch.float32)
    return torch.where(beta > 1, torch.zeros_like(alpha),
                       torch.where(beta == 1, alpha, torch.full_like(alpha, math.inf)))


def _posteriors(x, mu0, var0, mu1, var1, pi):
    log_p0 = -((x - mu0) ** 2) / 2 / var0 - 0.5 * torch.log(2 * math.pi * var0) + torch.log1p(-pi)
    log_p1 = -((x - mu1) ** 2) / 2 / var1 - 0.5 * torch.log(2 * math.pi * var1) + torch.log(pi)
    ma = torch.maximum(log_p0, log_p1)
    Z = ma + torch.log(torch.exp(log_p0 - ma) + torch.exp(log_p1 - ma))
    return log_p0, log_p1, Z


def gmm_fit(
    x: torch.Tensor,
    pi: torch.Tensor,
    split: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    scale: float = 1.0,
    tol: float = 1e-3,
    num_iters: int = 100,
    w: torch.Tensor = None,
    n=None,
):
    """Fit shared-variance 2-component GMMs with a Beta prior on pi, one
    lane per entry of ``pi`` and ``split`` (1D, same length).

    Same update equations and termination rule as topaz/stats.py:122-214.
    ``w`` (weights the size of ``x``) with ``n`` = their sum restricts the
    fit to a weighted subset (histogram EM passes counts). Returns per-lane
    (logp, mu0, var0, mu1, var1, pi), each of shape (L,).
    """
    x = x.reshape(-1)
    if w is None:
        w = torch.ones_like(x)
        n = x.numel()
    else:
        w = w.reshape(-1).to(x.dtype)
        if n is None:
            n = torch.sum(w)
    mu = torch.sum(x * w) / n
    xb, wb = x[None], w[None]
    pi = torch.as_tensor(pi, dtype=x.dtype, device=x.device).reshape(-1, 1)
    split = torch.as_tensor(split, dtype=x.dtype, device=x.device).reshape(-1, 1)

    def weighted_mean(p):
        s = torch.sum(p, dim=-1, keepdim=True)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        return torch.where(s > 0, torch.sum(xb * p, dim=-1, keepdim=True) / safe, mu)

    def stats(p0, p1, pi):
        mu0 = weighted_mean(p0)
        mu1 = weighted_mean(p1)
        var = torch.sum(p0 * (xb - mu0) ** 2 + p1 * (xb - mu1) ** 2,
                        dim=-1, keepdim=True) / n
        log_p0, log_p1, Z = _posteriors(xb, mu0, var, mu1, var, pi)
        logp = scale * torch.sum(wb * Z, dim=-1, keepdim=True) + beta_logpdf(pi, alpha, beta)
        return {"logp": logp, "log_p0": log_p0, "log_p1": log_p1, "Z": Z,
                "mu0": mu0, "var": var, "mu1": mu1, "pi": pi}

    p0 = (xb <= split).to(x.dtype) * wb
    s = stats(p0, wb - p0, pi)
    s["logp_cur"] = s["logp"]
    it = torch.zeros_like(pi, dtype=torch.int32)
    done = torch.zeros_like(pi, dtype=torch.bool)

    while True:
        running = (~done) & (it < num_iters)
        if not bool(running.any()):
            break
        p0 = torch.exp(s["log_p0"] - s["Z"]) * wb
        p1 = torch.exp(s["log_p1"] - s["Z"]) * wb
        s1 = torch.sum(p1, dim=-1, keepdim=True)
        a = alpha + s1
        b = beta + n - s1
        new = stats(p0, p1, (a - 1) / (a + b - 2))  # MAP pi (stats.py:174-177)
        step_done = (new["logp"] - s["logp_cur"]) <= tol
        new["logp_cur"] = torch.where(step_done, s["logp_cur"], new["logp"])
        s = {k: torch.where(running, new[k], v) for k, v in s.items()}
        done = torch.where(running, step_done, done)
        it = it + running.to(torch.int32)
    return tuple(s[k].reshape(-1) for k in ("logp", "mu0", "var", "mu1", "var", "pi"))


def _guard_degenerate(i, mus, stds, pis_out, logps, mean_all, rng):
    """Dead-frame guard, a documented divergence from the reference.

    A constant image (range 0) makes every EM lane's variance 0, so all
    logps are NaN; such frames normalize to zeros (mu=mean, std=1) with
    logp=-inf as the host-visible degeneracy signal. Non-constant images
    whose best lane still has a non-finite or zero std get the same
    fallback."""
    best_mu, best_std = mus[i], stds[i]
    degen = (rng <= 0) | ~torch.isfinite(best_std) | (best_std <= 0)
    one = torch.ones_like(best_std)
    mu_sel = torch.where(degen, mean_all, best_mu)
    std_sel = torch.where(degen, one, best_std)
    pi_sel = torch.where(degen, one, pis_out[i])
    logp_sel = torch.where(degen, torch.full_like(one, -math.inf), logps[i])
    return mu_sel, std_sel, pi_sel, logp_sel, mus, stds, pis_out, logps


def _select(logp_g, mu_g, var_g, pi_g, logp1c, mu1c, var1c, mean_all, rng):
    logps = torch.cat([logp_g, logp1c.reshape(1)])
    mus = torch.cat([mu_g, mu1c.reshape(1)])
    stds = torch.sqrt(torch.cat([var_g, var1c.reshape(1)]))
    pis_out = torch.cat([pi_g, torch.ones(1, dtype=pi_g.dtype, device=pi_g.device)])
    i = torch.argmax(logps)
    return _guard_degenerate(i, mus, stds, pis_out, logps, mean_all, rng)


def norm_fit(x: torch.Tensor, alpha: float = 900, beta: float = 1,
             scale: float = 1.0, num_iters: int = 100):
    """Try all 12 pi inits, pick the max-logp fit (topaz/stats.py:86-119).

    Returns (mu, std, pi, logp, mus, stds, pis, logps) where mu/std are the
    *second* (high-intensity) component's parameters, as in the reference.
    """
    x = x.reshape(-1).to(torch.float32)
    N = x.numel()
    pis = torch.tensor(DEFAULT_PIS, dtype=torch.float32, device=x.device)
    # linear-interpolation quantiles, in jnp.quantile's arithmetic
    xs = torch.sort(x).values
    q = (1 - pis) * (float(N) - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(low, 0, N - 1).long()
    high = torch.clamp(high, 0, N - 1).long()
    splits = xs[low] * low_w + xs[high] * high_w

    logp_g, _mu0, _var0, mu_g, var_g, pi_g = gmm_fit(
        x, pis[:-1], splits[:-1], alpha=alpha, beta=beta, scale=scale,
        num_iters=num_iters)

    # lane 11: single-component model (stats.py:104-107); torch's x.var() is
    # unbiased, as the reference
    mu1c = torch.mean(x)
    var1c = torch.mean((x - mu1c) ** 2) * (N / (N - 1))
    sum_z1c = torch.sum(-((x - mu1c) ** 2) / 2 / var1c - 0.5 * torch.log(2 * math.pi * var1c))
    logp1c = scale * sum_z1c + _beta_pdf_at_one(alpha, beta).to(x.device)
    return _select(logp_g, mu_g, var_g, pi_g, logp1c, mu1c, var1c,
                   torch.mean(x), torch.max(x) - torch.min(x))


def norm_fit_hist(x: torch.Tensor, bins: int = 65536, alpha: float = 900,
                  beta: float = 1, num_iters: int = 100):
    """Histogram-accelerated :func:`norm_fit`: bin all pixels once, then
    run the same weighted EM over the bin centers with the counts as
    weights. The only error is value quantization to the bin width. Same
    8-tuple return as norm_fit."""
    x = x.reshape(-1).to(torch.float32)
    n = torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
    lo, hi = torch.min(x), torch.max(x)
    width = torch.clamp(hi - lo, min=1e-30)
    idx = torch.clamp((((x - lo) / width) * bins).to(torch.int32), 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).to(torch.float32)
    centers = lo + (torch.arange(bins, dtype=torch.float32, device=x.device) + 0.5) * (width / bins)

    pis = torch.tensor(DEFAULT_PIS, dtype=torch.float32, device=x.device)
    # quantile init from the histogram CDF
    cdf = torch.cumsum(counts, 0)
    split_idx = torch.clamp(torch.searchsorted(cdf, (1 - pis) * n), 0, bins - 1)
    splits = centers[split_idx]

    logp_g, _mu0, _var0, mu_g, var_g, pi_g = gmm_fit(
        centers, pis[:-1], splits[:-1], alpha=alpha, beta=beta,
        num_iters=num_iters, w=counts, n=n)

    mu1c = torch.sum(centers * counts) / n
    var1c = torch.sum(counts * (centers - mu1c) ** 2) / (n - 1)
    logp1c = torch.sum(
        counts * (-((centers - mu1c) ** 2) / 2 / var1c
                  - 0.5 * torch.log(2 * math.pi * var1c))
    ) + _beta_pdf_at_one(alpha, beta).to(x.device)
    return _select(logp_g, mu_g, var_g, pi_g, logp1c, mu1c, var1c,
                   torch.sum(centers * counts) / n, hi - lo)


def _warn_degenerate():
    import warnings

    warnings.warn(
        "constant image (std=0): normalized output is all zeros (the "
        "reference produces NaNs for such frames, topaz/stats.py:36-83)")


def normalize(
    x,
    alpha: float = 900,
    beta: float = 1,
    num_iters: int = 100,
    sample: int = 1,
    method: str = "gmm",
    seed: int = 0,
    verbose: bool = False,
    bins: int = 0,
    device="cuda",
):
    """Normalize an image by affine or GMM statistics (topaz/stats.py:36-83).

    The GMM fit runs on ``device``. ``bins > 0`` uses the histogram-EM fast
    path over all pixels instead of the reference's random subsampling
    (``sample``, drawn on the host with ``np.random.default_rng(seed)``).
    Returns (normalized float32 array, metadata dict).
    """
    from topaz_tpu_torch.device import resolve_device

    x = np.asarray(x, dtype=np.float32)

    if method == "affine":
        mu = float(x.mean())
        std = float(x.std())
        metadata = {"mu": mu, "std": std, "pi": 1}
        if std == 0 or not np.isfinite(std):
            _warn_degenerate()
            return np.zeros_like(x, dtype=np.float32), metadata
        return ((x - mu) / std).astype(np.float32), metadata

    device = resolve_device(device)
    if bins > 0:
        mu, std, pi, logp, mus, stds, pis, logps = (
            v.cpu().numpy() for v in norm_fit_hist(
                torch.as_tensor(x, device=device), bins=int(bins), alpha=alpha,
                beta=beta, num_iters=num_iters))
        mu, std = float(mu), float(std)
        if np.isneginf(logp):
            _warn_degenerate()
        return ((x - mu) / std).astype(np.float32), {
            "mu": mu, "std": std, "pi": float(pi), "logp": float(logp),
            "mus": mus, "stds": stds, "pis": pis, "logps": logps,
            "alpha": alpha, "beta": beta, "sample": 1, "bins": int(bins),
        }

    x_sample = x
    scale = 1.0
    if sample > 1:
        n = int(np.round(x.size / sample))
        scale = x.size / n
        rng = np.random.default_rng(seed)
        x_sample = rng.choice(x.ravel(), size=n, replace=False)

    mu, std, pi, logp, mus, stds, pis, logps = (
        v.cpu().numpy() for v in norm_fit(
            torch.as_tensor(x_sample, device=device), alpha=alpha, beta=beta,
            scale=scale, num_iters=num_iters))
    mu, std = float(mu), float(std)
    if np.isneginf(logp):
        _warn_degenerate()
    out = ((x - mu) / std).astype(np.float32)
    metadata = {
        "mu": mu,
        "std": std,
        "pi": float(pi),
        "logp": float(logp),
        "mus": mus,
        "stds": stds,
        "pis": pis,
        "logps": logps,
        "alpha": alpha,
        "beta": beta,
        "sample": sample,
    }
    return out, metadata
