"""The port's GMM normalization against the JAX package.

Same bimodal data (numpy, seeded) through ``topaz_tpu.ops.gmm`` and
``topaz_tpu_torch.ops.gmm`` on the CPU. mu and std agree to rtol 1e-5, the
contract of the JAX package's own docstring (float32 sums run in another
order). The lanes that are not selected are held to rtol 1e-3: a slowly
converging lane stops when its logp (about 1e4 here) gains less than
tol = 1e-3, which is near float32's resolution at that size, so the two
stacks may stop such a lane one iteration apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from topaz_tpu.ops import gmm as jgmm
from topaz_tpu_torch.ops import gmm as tgmm
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
LANE_RTOL = 1e-3


def _mixture(seed, n, pi=0.3, mu0=0.0, mu1=2.0, std=0.7):
    rng = np.random.default_rng(seed)
    k = rng.random(n) < pi
    x = np.where(k, rng.normal(mu1, std, n), rng.normal(mu0, std, n))
    return x.astype(np.float32)


def _assert_fits_agree(got, want):
    names = ("mu", "std", "pi", "logp", "mus", "stds", "pis", "logps")
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0,
                                   rtol=RTOL if i < 4 else LANE_RTOL, err_msg=name)


@pytest.mark.parametrize("seed,pi", [(0, 0.3), (1, 0.7), (2, 0.05)])
def test_norm_fit_matches_jax(seed, pi):
    x = _mixture(seed, 12000, pi=pi)
    want = jgmm.norm_fit(jnp.asarray(x))
    got = tgmm.norm_fit(torch.from_numpy(x))
    _assert_fits_agree(got, want)


def test_norm_fit_with_scale_matches_jax():
    x = _mixture(3, 5000)
    want = jgmm.norm_fit(jnp.asarray(x), scale=10.0, num_iters=50)
    got = tgmm.norm_fit(torch.from_numpy(x), scale=10.0, num_iters=50)
    _assert_fits_agree(got, want)


def test_norm_fit_hist_matches_jax():
    x = _mixture(4, 30000)
    want = jgmm.norm_fit_hist(jnp.asarray(x), bins=4096)
    got = tgmm.norm_fit_hist(torch.from_numpy(x), bins=4096)
    _assert_fits_agree(got, want)


@pytest.mark.parametrize("bins,sample", [(0, 10), (0, 1), (2048, 1)])
def test_normalize_matches_jax(bins, sample):
    x = _mixture(5, 200 * 160).reshape(200, 160)
    want, wmd = jgmm.normalize(x, sample=sample, bins=bins, seed=3)
    got, gmd = tgmm.normalize(x, sample=sample, bins=bins, seed=3, device="cpu")
    assert got.dtype == np.float32 and got.shape == x.shape
    for k in ("mu", "std", "pi"):
        np.testing.assert_allclose(gmd[k], wmd[k], rtol=RTOL, err_msg=k)
    assert gmd["sample"] == wmd["sample"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def test_normalize_affine_matches_jax():
    x = _mixture(6, 4096).reshape(64, 64)
    want, wmd = jgmm.normalize(x, method="affine")
    got, gmd = tgmm.normalize(x, method="affine", device="cpu")
    assert gmd == wmd
    np.testing.assert_array_equal(got, want)


def test_gmm_fit_lanes_match_vmapped_jax():
    """The (L, N) batch with a per-lane done mask is the vmapped
    while_loop: each lane stops at its own iteration. Few points keep logp
    small, so tol decides each lane's stop well above float32's rounding
    and every lane is held to rtol 1e-5."""
    import jax

    x = _mixture(7, 600)
    pis = np.array(jgmm.DEFAULT_PIS[:-1], np.float32)
    splits = np.quantile(x, 1 - pis).astype(np.float32)
    want = jax.vmap(lambda p, s: jgmm.gmm_fit(jnp.asarray(x), p, s, alpha=900,
                                              beta=1))(
        jnp.asarray(pis), jnp.asarray(splits))
    got = tgmm.gmm_fit(torch.from_numpy(x), torch.from_numpy(pis),
                       torch.from_numpy(splits), alpha=900, beta=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("pi,alpha,beta", [
    (1.0, 900.0, 1.0), (0.0, 1.0, 5.0), (0.5, 2.0, 3.0), (0.98, 900.0, 1.0),
    (0.999999, 0.5, 0.5)])
def test_beta_logpdf_boundaries(pi, alpha, beta):
    got = float(tgmm.beta_logpdf(pi, alpha, beta))
    want = float(jgmm.beta_logpdf(jnp.float32(pi), alpha, beta))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, scipy.stats.beta.logpdf(np.float32(pi), alpha, beta),
                               rtol=1e-4)


@pytest.mark.parametrize("alpha,beta", [(900.0, 2.0), (900.0, 1.0), (3.0, 0.5)])
def test_beta_pdf_at_one(alpha, beta):
    assert float(tgmm._beta_pdf_at_one(alpha, beta)) == float(
        jgmm._beta_pdf_at_one(alpha, beta))


@pytest.mark.parametrize("bins", [0, 256])
def test_constant_image_guard(bins):
    x = np.full((32, 32), 3.5, np.float32)
    with pytest.warns(UserWarning, match="constant image"):
        got, md = tgmm.normalize(x, bins=bins, device="cpu")
    with pytest.warns(UserWarning, match="constant image"):
        want, wmd = jgmm.normalize(x, bins=bins)
    np.testing.assert_array_equal(got, np.zeros_like(x))
    np.testing.assert_array_equal(got, want)
    assert md["std"] == wmd["std"] == 1.0 and md["mu"] == wmd["mu"] == 3.5
    assert np.isneginf(md["logp"]) and np.isneginf(wmd["logp"])
