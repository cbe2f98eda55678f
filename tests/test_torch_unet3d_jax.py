"""The port's 3D U-Net at Topaz-Denoise's published ``unet-3d-10a`` widths
(nf 48, a 7^3 first layer, 3^3 elsewhere) against the JAX package's, on the
CPU. At these widths the port's one-channel first and last layers run as
``TapConv3d`` taps without gradients, so inference and ``Denoise3D`` take
that route here (at the small widths of ``test_torch_denoise3d.py`` both
layers stay ``nn.Conv3d``).

The same numpy weights go to both stacks (the JAX tree as it is, the port
through ``denoiser_from_numpy``). Tolerances, those of
``test_torch_denoise3d.py``, each with its reason:

* Forwards: rtol 1e-4, atol 1e-5 x the output's scale (its largest
  magnitude, at least 1): float32 convolutions, and the taps, summed in
  other orders. Two weight scales: JAX's init (uniform in +-1/sqrt(fan_in),
  under which activations shrink level by level) and the same draws
  He-scaled for leaky ReLU 0.1 (activations keep their size through every
  layer, as a trained network's do, so a fault in the first layer's taps
  reaches the output at full size).
* ``Denoise3D``: 1e-4 x the input volume's std, on a zero-mean volume: the
  JAX package takes each patch's mean and std with XLA's float32 CPU
  reductions, which drift from the port's sums; at JAX's init the network
  does not amplify that drift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.denoise import Denoise3D as JDenoise3D
from topaz_tpu.models import denoise as jmodels
from topaz_tpu_torch.denoise import Denoise3D
from topaz_tpu_torch.models import denoise_factory as tfactory
from topaz_tpu_torch.models.denoise import TapConv3d
from torch_threads import one_torch_thread  # noqa: F401

META = {"arch": "unet", "nf": 48, "base_width": 7, "top_width": 3, "dims": 3}
# uniform +-1/sqrt(fan_in) to uniform +-sqrt(6 / (fan_in (1 + 0.1^2)))
HE_SCALE = float(np.sqrt(18.0 / 1.01))


def _jax_tree(seed, he_scaled=False):
    params = jmodels.init_denoiser("unet", jax.random.PRNGKey(seed), nf=48, base_width=7,
                                   top_width=3, dims=3)
    params = jax.tree_util.tree_map(np.asarray, params)
    if he_scaled:
        params = {mod: {idx: {"w": p["w"] * HE_SCALE, "b": p["b"]} for idx, p in convs.items()}
                  for mod, convs in params.items()}
    return params


def _taps_on(net):
    return isinstance(net.enc1[0], TapConv3d) and isinstance(net.dec1[4], TapConv3d)


@pytest.mark.parametrize("he_scaled", [False, True])
def test_3d_unet_at_published_widths_matches_jax(he_scaled):
    params = _jax_tree(seed=10, he_scaled=he_scaled)
    model = tfactory.denoiser_from_numpy(META, params)
    assert _taps_on(model)
    x = np.random.default_rng(11).normal(size=(1, 34, 40, 36)).astype(np.float32)
    want = np.asarray(jmodels.APPLY_FNS["unet"](params, jnp.asarray(x)[..., None],
                                                dims=3))[..., 0]
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert got.shape == want.shape == x.shape
    if he_scaled:  # the output varies at the input's size, not only by its biases
        assert want.std() > 0.1 * x.std()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def published():
    """The published-width 3D U-Net in both packages with JAX's weights."""
    params = _jax_tree(seed=12)
    jd = JDenoise3D(meta=META, params=params)
    td = Denoise3D(meta=META, params=params, device="cpu")
    assert _taps_on(td.model)
    vol = np.random.default_rng(13).normal(0, 3, size=(16, 24, 20)).astype(np.float32)
    return jd, td, vol


@pytest.mark.parametrize("kw, route", [
    (dict(device_resident=True), "resident"),
    (dict(device_resident=False), "streaming"),
])
def test_denoise3d_at_published_widths_matches_jax(published, kw, route):
    jd, td, vol = published
    td.last_route = None
    want = jd.denoise(vol, patch_size=16, padding=8, verbose=False, **kw)
    got = td.denoise(vol, patch_size=16, padding=8, verbose=False, **kw)
    assert td.last_route == route
    assert got.dtype == np.float32 and got.shape == want.shape == vol.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * vol.std(), rtol=0)
