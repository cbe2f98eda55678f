"""The port's 3D denoisers, 3D filter, tiles and ``Denoise3D`` against the
JAX package's, on the CPU.

The same numpy weights go to both stacks (the JAX tree as it is, the port
through ``denoiser_from_numpy``) and the same numpy inputs through both.
Tolerances, each with its reason:

* 3D forwards at random init: rtol 1e-4, atol 1e-5 x the output's scale
  (its largest magnitude, at least 1): float32 convolutions summed in other
  orders; measured 2.4e-7.
* ``apply_kernel`` in 3D: 1e-5 of the output's scale, as in 2D.
* ``auto_patch_size``: equal (integer arithmetic).
* ``Denoise3D``: 1e-4 x the input volume's std. The JAX package takes each
  patch's mean and std with XLA's float32 CPU reductions, which drift from
  numpy's and the port's pairwise sums by up to ~3e-4 relative on a patch
  that is mostly zero fill; zero-mean volumes keep that drift small
  (measured 2.6e-6 x std). The output's own std is no yardstick at random
  init: the untrained model's output barely varies.
* ``PairedTiles3D``: bit-equal tiles for a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.denoise import Denoise3D as JDenoise3D
from topaz_tpu.denoise import auto_patch_size as j_auto_patch_size
from topaz_tpu.models import denoise as jmodels
from topaz_tpu.ops import filters as jfilters
from topaz_tpu.train.denoise_data import PairedTiles3D as JTiles
from topaz_tpu_torch.denoise import Denoise3D, auto_patch_size
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import denoise_factory as tfactory
from topaz_tpu_torch.ops import filters as tfilters
from topaz_tpu_torch.train.denoise_data import PairedTiles3D
from torch_threads import one_torch_thread  # noqa: F401


def _jax_tree(arch, seed, nf=4, base_width=7, top_width=3):
    params = jmodels.init_denoiser(arch, jax.random.PRNGKey(seed), nf=nf,
                                   base_width=base_width, top_width=top_width, dims=3)
    meta = {"arch": arch, "nf": nf, "base_width": base_width, "top_width": top_width,
            "dims": 3}
    return meta, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("shape", [(1, 32, 32, 32), (2, 40, 48, 36)])
@pytest.mark.parametrize("arch", ["unet", "unet-small", "unet3"])
def test_3d_forward_matches_jax(arch, shape):
    meta, params = _jax_tree(arch, seed=1)
    model = tfactory.denoiser_from_numpy(meta, params)
    assert isinstance(model.enc1[0], torch.nn.Conv3d)
    assert isinstance(model.enc1[2], torch.nn.MaxPool3d)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jmodels.APPLY_FNS[arch](params, jnp.asarray(x)[..., None],
                                              dims=3))[..., 0]
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None])[:, 0].numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_3d_checkpoint_layout_both_ways(tmp_path):
    """A 3D tree loads into Conv3d weights (DHWIO -> OIDHW) and comes back
    unchanged; the port's init draws at JAX's scales."""
    meta, params = _jax_tree("unet-small", seed=3)
    model = tfactory.denoiser_from_numpy(meta, params)
    meta2, back = tfactory.denoiser_to_numpy(model)
    assert meta2 == meta
    for mod, convs in params.items():
        for idx, p in convs.items():
            np.testing.assert_array_equal(back[mod][idx]["w"], p["w"])
            np.testing.assert_array_equal(back[mod][idx]["b"], p["b"])
    fresh = tfactory.new_denoiser("unet-3d", nf=4, base_width=7, dims=3, seed=0)
    assert fresh.meta == {"arch": "unet", "nf": 4, "base_width": 7, "top_width": 3, "dims": 3}
    w = fresh.enc1[0].weight
    assert w.shape == (4, 1, 7, 7, 7) and 0 < w.abs().max() <= 1 / np.sqrt(7 ** 3)
    assert torch.equal(w, tfactory.new_denoiser("unet-3d", nf=4, base_width=7, dims=3,
                                                seed=0).enc1[0].weight)
    affine = tfactory.new_denoiser("affine", dims=3)
    assert affine.filter.weight.shape == (1, 1, 31, 31, 31)
    assert not affine.filter.weight.any()
    with pytest.raises(FileNotFoundError):
        tfactory.load_denoiser("unet-3d-10a", device="cpu")


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_apply_kernel_3d_matches_jax(sigma):
    x = np.random.default_rng(4).normal(size=(20, 26, 23)).astype(np.float32)
    w = tfilters.gaussian_denoise_kernel(sigma, dims=3)
    np.testing.assert_array_equal(w, jfilters.gaussian_denoise_kernel(sigma, dims=3))
    want = np.asarray(jfilters.apply_kernel(x, w, dims=3))
    got = tfilters.apply_kernel(x, w, device="cpu", dims=3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    even = np.random.default_rng(5).normal(size=(4, 3, 6)).astype(np.float32)
    want = np.asarray(jfilters.apply_kernel(x, even, dims=3))
    got = tfilters.apply_kernel(x, even, device="cpu", dims=3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)
    with pytest.raises(ValueError, match="dims=2"):
        tfilters.apply_kernel(x, w, device="cpu")


def test_auto_patch_size_matches_jax():
    shapes = [(192, 384, 384), (64, 64, 64), (20, 28, 24), (300, 1024, 1440), (7, 500, 90)]
    for shape in shapes:
        for padding in (0, 4, 16, 48, 64, 100, 111):
            assert auto_patch_size(shape, padding) == j_auto_patch_size(shape, padding)
    with pytest.raises(ValueError, match="auto-patch"):
        auto_patch_size((64, 64, 64), padding=113)
    with pytest.raises(ValueError, match="auto-patch"):
        j_auto_patch_size((64, 64, 64), padding=113)


@pytest.fixture(scope="module")
def denoisers():
    """A unet-small 3D denoiser in both packages with JAX's weights."""
    jd = JDenoise3D.from_arch("unet-small", nf=4, base_width=7, dims=3, seed=2)
    td = Denoise3D(meta=jd.meta, params=jax.tree_util.tree_map(np.asarray, jd.params),
                   device="cpu")
    vol = np.random.default_rng(6).normal(0, 3, size=(20, 28, 24)).astype(np.float32)
    return jd, td, vol


@pytest.mark.parametrize("kw,route", [
    (dict(patch_size=8, padding=4, device_resident=True), "resident"),
    (dict(patch_size=8, padding=4, device_resident=False), "streaming"),
    (dict(patch_size=8, padding=4, device_resident=False, batch_size=3), "streaming"),
    (dict(patch_size=0, padding=4), None),
    (dict(patch_size=-2, padding=4), "resident"),
])
def test_denoise3d_matches_jax(denoisers, kw, route):
    jd, td, vol = denoisers
    td.last_route = None
    want = jd.denoise(vol, verbose=False, **kw)
    got = td.denoise(vol, verbose=False, **kw)
    assert td.last_route == route
    assert got.dtype == np.float32 and got.shape == want.shape == vol.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * vol.std(), rtol=0)


def test_denoise3d_routing_and_guards(denoisers, capsys):
    """Over the residency cap the port streams (and refuses
    ``device_resident=True``); a patch below the pyramid's minimum is named
    with its flag; a 2D model is refused."""
    jd, _, vol = denoisers
    td = Denoise3D(meta=jd.meta, params=jax.tree_util.tree_map(np.asarray, jd.params),
                   device="cpu")
    resident = td.denoise(vol, 8, 4, verbose=True)
    assert "device-resident: 36 patches of 16^3" in capsys.readouterr().err
    td._DEVICE_RESIDENT_CAP = 0
    np.testing.assert_allclose(td.denoise(vol, 8, 4, verbose=False), resident,
                               atol=1e-5 * vol.std(), rtol=0)
    assert td.last_route == "streaming"
    with pytest.raises(ValueError, match="cannot stay resident"):
        td.denoise(vol, 8, 4, verbose=False, device_resident=True)
    with pytest.raises(ValueError, match="minimum input"):
        td.denoise(vol, 2, 1, verbose=False)
    with pytest.raises(ValueError, match="3D denoiser"):
        Denoise3D("unet-small", device="cpu")


def test_denoise_tomogram_gaussian_matches_jax(denoisers, tmp_path):
    """``denoise_tomogram`` with ``-g``: the denoised volume, Gaussian-
    filtered in 3D, written with the header's min/max/mean; the output
    name rule with and without an output directory."""
    from topaz_tpu.denoise import denoise_tomogram as j_denoise_tomogram
    from topaz_tpu_torch.denoise import denoise_tomogram

    jd, td, vol = denoisers
    path = str(tmp_path / "tomo.mrc")
    mrc.write(path, vol)
    (tmp_path / "jax").mkdir()
    want = j_denoise_tomogram(path, jd, outdir=str(tmp_path / "jax"), patch_size=8,
                              padding=4, gaus=1.0, verbose=False)
    got = denoise_tomogram(path, td, patch_size=8, padding=4, gaus=1.0, verbose=False)
    np.testing.assert_allclose(got, want, atol=1e-4 * vol.std(), rtol=0)
    written, header, _ = mrc.read(str(tmp_path / "tomo.denoised.mrc"))
    np.testing.assert_array_equal(written, got)
    assert int(header.mode) == 2
    np.testing.assert_allclose([header.amin, header.amax, header.amean],
                               [got.min(), got.max(), got.mean()], rtol=1e-6)


def _tomo_pair(tmp_path, shape, seed=7, as_dirs=True):
    rng = np.random.default_rng(seed)
    even = rng.normal(size=shape).astype(np.float32)
    odd = (even + 0.5 * rng.normal(size=shape)).astype(np.float32)
    if not as_dirs:
        mrc.write(str(tmp_path / "even.mrc"), even)
        mrc.write(str(tmp_path / "odd.mrc"), odd)
        return str(tmp_path / "even.mrc"), str(tmp_path / "odd.mrc")
    (tmp_path / "even").mkdir()
    (tmp_path / "odd").mkdir()
    for name, scale in (("a.mrc", 1.0), ("b.mrc", 2.0)):
        mrc.write(str(tmp_path / "even" / name), even * scale)
        mrc.write(str(tmp_path / "odd" / name), odd * scale + 1)
    return str(tmp_path / "even"), str(tmp_path / "odd")


@pytest.mark.parametrize("shape,tile,as_dirs", [
    ((32, 40, 36), 16, True),
    ((30, 33, 35), 15, False),   # odd tile size: c - t//2 .. c - t//2 + t
    ((24, 24, 24), 9, True),
])
def test_paired_tiles_3d_bit_equal(tmp_path, shape, tile, as_dirs):
    even, odd = _tomo_pair(tmp_path, shape, as_dirs=as_dirs)
    j, t = JTiles(even, odd, tile, 12, 5, seed=3), PairedTiles3D(even, odd, tile, 12, 5, seed=3)
    assert j.train_tiles == t.train_tiles and j.test_tiles == t.test_tiles
    for mode in ("train", "test"):
        for shuffle in (True, False):
            for (jx, jy), (tx, ty) in zip(j.batches(5, mode, shuffle),
                                          t.batches(5, mode, shuffle), strict=True):
                assert tx.shape[1:] == (tile,) * 3
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)


def test_paired_tiles_3d_guards(tmp_path):
    even, odd = _tomo_pair(tmp_path, (32, 32, 32))
    for cls in (JTiles, PairedTiles3D):
        with pytest.raises(ValueError, match="strictly larger than the crop"):
            cls(even, odd, 32, 8, 4)
        with pytest.raises(ValueError, match="tilesize must be > 0"):
            cls(even, odd, 0, 8, 4)
    empty = tmp_path / "none"
    empty.mkdir()
    with pytest.raises(ValueError, match="at least 1 even/odd"):
        PairedTiles3D(str(empty), str(empty), 8, 8, 4)
