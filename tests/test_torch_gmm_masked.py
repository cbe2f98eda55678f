"""The port's masked, batched GMM fits against the JAX package.

Three images padded into one 64 x 64 bucket (valid 60 x 50, 64 x 64 and
33 x 64), made with numpy from a seed, go through the JAX package's masked
``norm_fit(w=)`` / ``norm_fit_hist(w=)``, vmapped over images as its
pipeline runs them, and through the port's batched call. The selected mu,
std, pi and logp agree to rtol 1e-5 (float32 sums run in other orders), and
each image's result also matches the port's unmasked fit of the cropped
image to the same tolerance: padding must not reach the fit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.ops import gmm as jgmm
from topaz_tpu_torch.ops import gmm as tgmm
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
VALID = [(60, 50), (64, 64), (33, 64)]


def _bucket(seed, dead=None):
    """(3, 64*64) pixels and 0/1 weights; image ``dead`` is constant."""
    rng = np.random.default_rng(seed)
    x = np.zeros((3, 64, 64), np.float32)
    w = np.zeros((3, 64, 64), np.float32)
    for b, (h, wd) in enumerate(VALID):
        k = rng.random((h, wd)) < 0.3
        x[b, :h, :wd] = np.where(k, rng.normal(2, 0.7, (h, wd)), rng.normal(0, 0.7, (h, wd)))
        w[b, :h, :wd] = 1
        # padding holds junk: only the weights may keep it out of the fit
        x[b, h:, :] = 50.0
        x[b, :, wd:] = -50.0
    if dead is not None:
        h, wd = VALID[dead]
        x[dead, :h, :wd] = 4.25
    return x.reshape(3, -1), w.reshape(3, -1)


def _fits(bins):
    if bins:
        return (lambda x, w: jgmm.norm_fit_hist(x, bins=bins, w=w),
                lambda x, w=None: tgmm.norm_fit_hist(x, bins=bins, w=w))
    return (lambda x, w: jgmm.norm_fit(x, w=w),
            lambda x, w=None: tgmm.norm_fit(x, w=w))


@pytest.mark.parametrize("bins", [0, 4096])
def test_masked_batched_fit_matches_jax_and_the_cropped_fit(bins):
    jfit, tfit = _fits(bins)
    x, w = _bucket(seed=bins)
    want = jax.vmap(jfit)(jnp.asarray(x), jnp.asarray(w))
    got = tfit(torch.from_numpy(x), torch.from_numpy(w))
    for i, name in enumerate(("mu", "std", "pi", "logp")):
        assert got[i].shape == (3,)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=RTOL,
                                   atol=0, err_msg=name)
    assert got[4].shape == (3, 12)
    for b, (h, wd) in enumerate(VALID):
        crop = np.ascontiguousarray(x[b].reshape(64, 64)[:h, :wd]).ravel()
        solo = tfit(torch.from_numpy(crop))
        for i, name in enumerate(("mu", "std", "pi", "logp")):
            np.testing.assert_allclose(float(got[i][b]), float(solo[i]), rtol=RTOL,
                                       err_msg=f"image {b} {name}")


@pytest.mark.parametrize("bins", [0, 4096])
def test_dead_frame_in_a_batch(bins):
    """A constant image gets std 1 and logp -inf, as JAX's guard gives it;
    its batchmates keep the fits they have alone."""
    jfit, tfit = _fits(bins)
    x, w = _bucket(seed=7, dead=1)
    got = tfit(torch.from_numpy(x), torch.from_numpy(w))
    want = jax.vmap(jfit)(jnp.asarray(x), jnp.asarray(w))
    assert float(got[1][1]) == 1.0 and float(got[0][1]) == 4.25
    assert np.isneginf(float(got[3][1])) and np.isneginf(float(want[3][1]))
    for b in (0, 2):
        for i in range(4):
            np.testing.assert_allclose(float(got[i][b]), float(want[i][b]), rtol=RTOL)


def test_unmasked_batch_equals_one_image_at_a_time():
    """Without weights, each row of a batch is fit as the 1-image call fits
    it, bit for bit (the same reductions, one row each)."""
    x, _ = _bucket(seed=3)
    for bins in (0, 512):
        _, tfit = _fits(bins)
        batch = tfit(torch.from_numpy(x))
        for b in range(3):
            solo = tfit(torch.from_numpy(x[b]))
            for i in range(8):
                assert torch.equal(batch[i][b], solo[i]), (bins, b, i)
