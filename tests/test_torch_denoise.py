"""The port's denoisers, filters and ``Denoise`` workflow against the JAX
package's, on the CPU.

The same numpy weights go to both stacks (the JAX tree as it is, the port
through ``denoiser_from_numpy``) and the same numpy inputs through both.
Tolerances, each with its reason:

* architectures at random init: rtol 1e-4, atol 1e-5, the bound the JAX
  package holds its own fused decoder to against the plain one (float32
  convolutions summed in other orders);
* bundled weights at full width, ``Denoise`` whole and patched: atol
  1e-4 * std of the JAX output (rtol 1e-4 for the models alone);
* nearest-upsample index tables: exact;
* lowpass, apply_kernel, spatial_covariance, correct_spatial_covariance:
  1e-5 of the output's scale (its largest magnitude, at least 1): the
  inverse Gaussian filter gives values near 100;
* bf16: mean abs difference over mean |y_f32| below 0.05, the JAX package's
  own bound for its bf16 mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.denoise import Denoise as JDenoise
from topaz_tpu.models import denoise as jmodels
from topaz_tpu.models import denoise_factory as jfactory
from topaz_tpu.ops import filters as jfilters
from topaz_tpu.ops import fourier as jfourier
from topaz_tpu_torch.denoise import Denoise, denoise_image, denoise_stack, denoise_stream
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import denoise as tmodels
from topaz_tpu_torch.models import denoise_factory as tfactory
from topaz_tpu_torch.ops import filters as tfilters
from topaz_tpu_torch.ops import fourier as tfourier
from topaz_tpu_torch.ops import unet_edges as tedges
from topaz_tpu_torch.utils.batching import iterate_prefetched
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["unet", "unet3", "unet-small", "unet2", "fcnet", "affine"]


def _random_tree(arch, rng, nf=8, base_width=7, top_width=3):
    """A JAX-layout parameter tree of numpy arrays, drawn like torch's
    default init (the JAX init zeroes the affine filter)."""
    params = {}
    for mod, convs in tmodels.arch_layout(arch, nf, base_width, top_width).items():
        entry = {}
        for idx, (k, cin, cout) in convs.items():
            bound = 1 / np.sqrt(cin * k * k)
            p = {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32),
                 "b": rng.uniform(-bound, bound, cout).astype(np.float32)}
            if idx:
                entry[idx] = p
            else:
                entry = p
        params[mod] = entry
    meta = {"arch": arch, "nf": nf, "base_width": base_width,
            "top_width": top_width, "dims": 2}
    return meta, params


def _jax_forward(arch, params, x):
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(jmodels.APPLY_FNS[arch](tree, jnp.asarray(x)[..., None]))[..., 0]


def _port_forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)[:, None])[:, 0].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_layout_matches_jax(arch):
    for kw in ({}, {"nf": 8, "base_width": 7, "top_width": 3}):
        assert tmodels.arch_layout(arch, **kw) == jmodels.arch_layout(arch, **kw)
    assert tmodels.min_input_size(arch) == jmodels.min_input_size(arch)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 67, 91)])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_jax(arch, shape):
    rng = np.random.default_rng(0)
    meta, params = _random_tree(arch, rng)
    model = tfactory.denoiser_from_numpy(meta, params)
    assert not model.training and model.meta == meta
    x = rng.normal(size=shape).astype(np.float32)
    want = _jax_forward(arch, params, x)
    got = _port_forward(model, x)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_infer_denoiser_arch_matches_jax():
    rng = np.random.default_rng(1)
    for arch in ARCHS:
        sd = {k: v.numpy() for k, v in
              tfactory.denoiser_from_numpy(*_random_tree(arch, rng)).state_dict().items()}
        for cls in (None, "UDenoiseNet3"):
            assert (tmodels.infer_denoiser_arch(sd, cls)
                    == jmodels.infer_denoiser_arch(sd, cls))


def test_nearest_index_rule_matches_jax(monkeypatch):
    """Every (n_in, n_out) pair up to 40: the port's index table and its
    resize equal the JAX package's ``_up_nearest`` exactly. The JAX
    function's own code runs with numpy standing in for ``jnp`` (the same
    integer arithmetic, without compiling 1600 shapes); the sizes a
    micrograph's levels meet are also run through JAX itself."""
    def up(src, n_out):
        return np.asarray(jmodels._up_nearest(src[None, :, None, None], (n_out, 1)))[0, :, 0, 0]

    for n_in, n_out in ((3, 6), (16, 33), (45, 91), (33, 67), (40, 40), (7, 3)):
        src = np.arange(n_in, dtype=np.float32)
        np.testing.assert_array_equal(src[tedges.nearest_index(n_in, n_out).numpy()],
                                      up(jnp.asarray(src), n_out))
    monkeypatch.setattr(jmodels, "jnp", np)
    for n_in in range(1, 41):
        src = np.arange(n_in, dtype=np.float32)
        for n_out in range(1, 41):
            want = up(src, n_out)
            np.testing.assert_array_equal(src[tedges.nearest_index(n_in, n_out).numpy()], want)
            got = tedges.up_nearest(torch.from_numpy(src)[None, None, :, None], (n_out, 1))
            np.testing.assert_array_equal(got[0, 0, :, 0].numpy(), want)


@pytest.mark.parametrize("alias", ["unet", "unet-small", "fcnn", "affine"])
def test_bundled_denoisers_match_jax(alias, capsys):
    meta, params = jfactory.load_denoiser(alias)
    model = tfactory.load_denoiser(alias, device="cpu")
    if alias == "unet":
        assert "falling back to unet-v0.2.1" in capsys.readouterr().err
        assert sum(p.numel() for p in model.parameters()) == 969745
    assert model.meta == meta
    assert all(p.device.type == "cpu" for p in model.parameters())
    x = np.random.default_rng(2).normal(size=(1, 96, 96)).astype(np.float32)
    want = _jax_forward(meta["arch"], params, x)
    got = _port_forward(model, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.std())


def test_load_denoiser_refuses_what_is_not_ported(tmp_path):
    """A file that is no checkpoint raises the .sav reader's error (the
    reader itself: tests/test_torch_sav.py); a missing file or the 3D
    aliases, whose weights are not in the repo, raise FileNotFoundError."""
    from topaz_tpu_torch.models.convert import SavFormatError

    sav = tmp_path / "model.sav"
    sav.write_bytes(b"\x80\x02")
    with pytest.raises(SavFormatError, match="does not read this file"):
        tfactory.load_denoiser(str(sav), device="cpu")
    with pytest.raises(FileNotFoundError):
        tfactory.load_denoiser(str(tmp_path / "missing.npz"), device="cpu")
    with pytest.raises(FileNotFoundError, match="not bundled"):
        tfactory.load_denoiser("unet-3d", device="cpu")


def test_npz_checkpoint_loads_by_path(tmp_path):
    from topaz_tpu.utils.serialize import save_checkpoint

    meta, params = _random_tree("unet-small", np.random.default_rng(3))
    path = str(tmp_path / "small.npz")
    save_checkpoint(path, meta, params=params)
    model = tfactory.load_denoiser(path, device="cpu")
    x = np.random.default_rng(4).normal(size=(1, 40, 48)).astype(np.float32)
    np.testing.assert_allclose(_port_forward(model, x), _jax_forward("unet-small", params, x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (67, 90)])
@pytest.mark.parametrize("factor", [2, 3.5])
def test_lowpass_matches_jax(shape, factor):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jfourier.lowpass(jnp.asarray(x), factor))
    _close(tfourier.lowpass(x, factor, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tfourier.lowpass(x, 1, device="cpu").numpy(), x)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)


def _image(shape=(80, 72), seed=6):
    """A correlated test image: white noise smoothed, plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x = np.asarray(jfilters.apply_kernel(x, jfilters.gaussian_denoise_kernel(1.5)))
    return (x + 0.3 * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("kernel", ["gaussian", "inv_gaussian", "even"])
def test_apply_kernel_matches_jax(kernel):
    x = _image()
    w = {"gaussian": tfilters.gaussian_denoise_kernel(2.0),
         "inv_gaussian": tfilters.inv_gaussian_kernel(1.0),
         "even": np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)}[kernel]
    if kernel != "even":
        np.testing.assert_array_equal(
            w, {"gaussian": jfilters.gaussian_denoise_kernel(2.0),
                "inv_gaussian": jfilters.inv_gaussian_kernel(1.0)}[kernel])
    want = np.asarray(jfilters.apply_kernel(x, w))
    _close(tfilters.apply_kernel(x, w, device="cpu").numpy(), want)


def test_spatial_covariance_matches_jax():
    x = _image((97, 83))
    want = np.asarray(jfilters.spatial_covariance(jnp.asarray(x), n=11))
    got = tfilters.spatial_covariance(x, n=11, device="cpu").numpy()
    assert got.shape == (11, 11)
    _close(got, want)
    w_got, _ = tfilters.estimate_unblur_filter(x, device="cpu")
    w_want, _ = jfilters.estimate_unblur_filter(x)
    _close(w_got, w_want)


def test_estimate_unblur_filter_gaussian_matches_jax():
    """The Gaussian whitening fit on correlated noise (the JAX package's own
    input, tests/test_denoise.py:400-403): sigma and alpha within 1e-3
    relative (the same BFGS from the same start on float32 losses summed in
    other orders); the inverse filter and the covariance within 1e-4."""
    x = np.random.default_rng(42).normal(size=(80, 90)).astype(np.float32)
    x = x + 0.5 * np.roll(x, 1, axis=0) + 0.5 * np.roll(x, 1, axis=1)
    w_want, sigma_want, alpha_want, cov_want = jfilters.estimate_unblur_filter_gaussian(x)
    w_got, sigma_got, alpha_got, cov_got = tfilters.estimate_unblur_filter_gaussian(
        x, device="cpu")
    np.testing.assert_allclose(sigma_got, sigma_want, rtol=1e-3)
    np.testing.assert_allclose(alpha_got, alpha_want, rtol=1e-3)
    assert w_got.shape == (11, 11) and w_got.dtype == np.float32
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cov_got, cov_want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("patch", [1, 2])
def test_correct_spatial_covariance_matches_jax(patch):
    x = _image((90, 77))
    want = np.asarray(jfilters.correct_spatial_covariance(x, patch=patch))
    _close(tfilters.correct_spatial_covariance(x, patch=patch, device="cpu").numpy(), want)


def _micrograph(size=256, seed=8):
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    return make_ctf_micrograph(np.random.default_rng(seed), size=size, n_particles=0)[0]


@pytest.fixture(scope="module")
def unet_pair():
    return JDenoise("unet"), Denoise("unet", device="cpu")


@pytest.mark.parametrize("patch_size,padding", [(-1, 0), (96, 32)])
def test_denoise_matches_jax(unet_pair, patch_size, padding):
    """Whole image (-s 0) and patched (-s 96 -p 32: one interior and eight
    border patches of three sizes) with the bundled unet."""
    jd, td = unet_pair
    x = _micrograph()
    want = jd.denoise(x, patch_size=patch_size, padding=padding)
    got = td.denoise(x, patch_size=patch_size, padding=padding)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * want.std(), rtol=0)


def test_denoise_image_filters_match_jax():
    """The filter pipeline in front of the model (lowpass, pixel cutoff,
    gaussian / inverse gaussian / deconvolution, two models averaged,
    --normalize, --downsample) against the JAX package's."""
    from topaz_tpu.denoise import denoise_image as jdenoise_image

    rng = np.random.default_rng(9)
    trees = [_random_tree("unet-small", rng) for _ in range(2)]
    jmodels_ = [JDenoise(meta=m, params=p) for m, p in trees]
    tmodels_ = [Denoise(device="cpu", meta=m, params=p) for m, p in trees]
    x = _micrograph(160, seed=10)
    for kw in ({"lowpass": 2, "cutoff": 2.5, "gaus": 1.0},
               {"inv_gaus": 1.0, "normalize": True},
               {"deconvolve": True, "deconv_patch": 2, "downsample": 2}):
        want = jdenoise_image(x, jmodels_, **kw)
        got = denoise_image(x, tmodels_, **kw)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4 * want.std(), rtol=0)


def test_min_extent_guards():
    td = Denoise(device="cpu", meta=_random_tree("unet", np.random.default_rng(11))[0],
                 params=_random_tree("unet", np.random.default_rng(11))[1])
    with pytest.raises(ValueError, match="minimum input of 32"):
        td.denoise(np.zeros((20, 64), np.float32))
    with pytest.raises(ValueError, match="-s/--patch-size"):
        td.denoise(np.zeros((128, 128), np.float32), patch_size=8, padding=4)
    with pytest.raises(ValueError, match="--stack"):
        td.denoise(np.zeros((2, 64, 64), np.float32))


def _affine():
    return Denoise(device="cpu", meta={"arch": "affine", "dims": 2},
                   params=_random_tree("affine", np.random.default_rng(12))[1])


def test_whole_image_oom_falls_back_to_patches(monkeypatch, capsys):
    """A device out-of-memory on the whole image degrades to patch
    denoising at a shrunken patch size, with a warning, and later images
    as large go straight to patches."""
    x = np.random.default_rng(13).normal(0, 2, (200, 200)).astype(np.float32)
    dn = _affine()
    forward = dn.model.forward
    calls = {"oom": 0}

    def boom(t):
        if t.shape[-2] * t.shape[-1] >= x.size:
            calls["oom"] += 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 6.00 GiB")
        return forward(t)

    monkeypatch.setattr(dn.model, "forward", boom)
    y = dn.denoise(x)
    assert calls["oom"] == 1 and dn._oom_area == x.size
    assert "falling back to -s 64 -p 32" in capsys.readouterr().err
    ref = _affine().denoise_patches(x, 64, padding=32)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    y2 = dn.denoise(x)
    assert calls["oom"] == 1
    torch.testing.assert_close(y2, ref, rtol=0, atol=0)


def test_non_oom_errors_still_raise(monkeypatch):
    dn = _affine()

    def broken(t):
        raise RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED")

    monkeypatch.setattr(dn.model, "forward", broken)
    with pytest.raises(RuntimeError, match="CUDNN_STATUS"):
        dn.denoise(np.zeros((64, 64), np.float32))
    assert dn._oom_area is None


def test_batch_oom_falls_back_to_frames(monkeypatch, capsys):
    dn = _affine()
    frames = np.random.default_rng(14).normal(size=(3, 40, 40)).astype(np.float32)
    forward = dn.model.forward

    def boom(t):
        if t.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return forward(t)

    monkeypatch.setattr(dn.model, "forward", boom)
    y = dn.denoise_batch(frames)
    assert "one at a time" in capsys.readouterr().err
    for i in range(3):
        torch.testing.assert_close(y[i], _affine().denoise(frames[i]), rtol=0, atol=1e-6)


def test_denoise_stack_batched_matches_per_frame(tmp_path):
    dn = _affine()
    stack = np.random.default_rng(15).normal(size=(10, 48, 40)).astype(np.float32)
    mrc.write(str(tmp_path / "s.mrcs"), stack)
    out = denoise_stack(str(tmp_path / "s.mrcs"), str(tmp_path / "d.mrcs"), [dn],
                        patch_size=-1, normalize=True)
    for i in (0, 7, 9):
        ref = denoise_image(stack[i], [dn], patch_size=-1, normalize=True)
        np.testing.assert_allclose(out[i], ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mrc.read(str(tmp_path / "d.mrcs"))[0], out)


def test_denoise_stream_writes_each_micrograph_and_surfaces_save_errors(tmp_path):
    dn = _affine()
    rng = np.random.default_rng(17)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=(40, 48)).astype(np.float32))
    denoise_stream(paths, str(tmp_path / "out"), models=[dn], patch_size=-1)
    for i, path in enumerate(paths):
        got = mrc.read(str(tmp_path / "out" / f"m{i}.mrc"))[0]
        np.testing.assert_array_equal(got, denoise_image(mrc.read(path)[0], [dn]))
    with pytest.raises(ValueError, match="Unsupported output format"):
        denoise_stream(paths, str(tmp_path / "bad"), format="xyz", models=[dn])


def test_bf16_close_to_f32_and_to_jax_bf16():
    x = np.random.default_rng(16).normal(0, 2, (96, 96)).astype(np.float32)
    y32 = Denoise("unet-small", device="cpu").denoise(x).numpy()
    b16 = Denoise("unet-small", device="cpu", dtype="bf16")
    assert next(b16.model.parameters()).dtype == torch.bfloat16
    y16 = b16.denoise(x)
    assert y16.dtype == torch.float32
    y16 = y16.numpy()
    yj16 = JDenoise("unet-small", dtype="bf16").denoise(x, patch_size=-1)
    scale = np.abs(y32).mean()
    assert np.mean(np.abs(y32 - y16)) / scale < 0.05
    assert np.mean(np.abs(yj16 - y16)) / scale < 0.05


def test_iterate_prefetched_order_and_errors():
    assert list(iterate_prefetched(range(7), maxsize=0)) == list(range(7))
    assert list(iterate_prefetched(lambda: iter([None, 1]))) == [None, 1]

    def bad():
        yield 1
        raise OSError("unreadable micrograph")

    got = []
    with pytest.raises(OSError, match="unreadable"):
        for item in iterate_prefetched(bad):
            got.append(item)
    assert got == [1]


@pytest.mark.parametrize("entry", ["Denoise", "load_denoiser", "lowpass", "apply_kernel",
                                   "spatial_covariance", "correct_spatial_covariance"])
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    from topaz_tpu_torch.device import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((32, 32), np.float32)
    call = {
        "Denoise": lambda: Denoise("affine"),
        "load_denoiser": lambda: tfactory.load_denoiser("affine"),
        "lowpass": lambda: tfourier.lowpass(x, 2),
        "apply_kernel": lambda: tfilters.apply_kernel(x, np.ones((3, 3))),
        "spatial_covariance": lambda: tfilters.spatial_covariance(x),
        "correct_spatial_covariance": lambda: tfilters.correct_spatial_covariance(x),
    }[entry]
    with pytest.raises(DeviceUnavailableError):
        call()
