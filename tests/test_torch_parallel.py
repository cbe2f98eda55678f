"""The port's scale-out (parallel/devices.py, parallel/mesh.py) against the
JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, the
port's over a list that repeats the CPU (``[cpu] * n``): the same shard
counts, halos and numpy weights on both. Tolerances, each with its reason:

* batched scorer: 1e-5, the JAX package's own bound for its batched scorer
  against one device (the same float32 convolutions per image);
* halo dense scorer: 1e-4, the JAX package's own bound for halo against
  whole-image scoring (the shards' convolutions sum in other orders);
* halo denoiser (affine, the small U-Net, a 3D U-Net): 1e-4 x the image's
  std, the port's bound for its denoisers against JAX's;
* data-parallel train step: parameters within 1e-5 relative (atol 1e-8)
  after one Adam step, against JAX's over 4 data shards and against the
  port's own one-device step on the whole batch;
* the mesh-shape rules: exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.denoise_factory import apply_fn_for as japply_fn_for
from topaz_tpu.models.denoise_factory import load_denoiser as jload_denoiser
from topaz_tpu.models.denoise_factory import new_denoiser as jnew_denoiser
from topaz_tpu.parallel import devices as jdevices
from topaz_tpu.parallel import mesh as jmesh
from topaz_tpu.train import trainer as jtrainer
from topaz_tpu.train.methods import make_loss_fn as j_loss_fn
from topaz_tpu_torch.device import DeviceUnavailableError
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models.denoise_factory import denoiser_from_numpy
from topaz_tpu_torch.models.picker import make_picker_spec as t_spec
from topaz_tpu_torch.parallel import devices as tdevices
from topaz_tpu_torch.parallel import mesh as tmesh
from topaz_tpu_torch.train.methods import make_loss_fn as t_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _jmesh(n_data, n_space):
    return jmesh.make_mesh(n_data=n_data, n_space=n_space,
                           devices=jax.devices()[: n_data * n_space])


def _pickers(seed=0, bn=False):
    spec, params, state = jfactory.new_picker("resnet8", units=4, bn=bn, seed=seed)
    params, state = (jax.tree_util.tree_map(np.asarray, t) for t in (params, state))
    model = tfactory.picker_from_numpy(t_spec("resnet8", units=4, bn=bn), params, state)
    return spec, params, state, model


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("batch_size", [None, 1, 2, 3, 4, 6, 8])
def test_mesh_shape_rules_match_jax(n, batch_size):
    def shape(m):
        return None if m is None else dict(m.shape)

    jd, td = jax.devices()[:n], [CPU] * n
    assert shape(tdevices.data_mesh_for(td, batch_size)) == \
        shape(jdevices.data_mesh_for(jd, batch_size))
    assert shape(tdevices.hybrid_mesh_for(td, batch_size)) == \
        shape(jdevices.hybrid_mesh_for(jd, batch_size))
    if batch_size is None:
        assert shape(tdevices.space_mesh_for(td)) == shape(jdevices.space_mesh_for(jd))


def test_resolve_devices_without_a_card():
    assert tdevices.resolve_devices("cpu") == [CPU]
    assert not tdevices.maybe_distributed_init()
    with pytest.raises(DeviceUnavailableError, match="-d -2"):
        tdevices.resolve_devices(-2)
    m = tmesh.make_mesh(n_data=2, n_space=3, devices=[CPU] * 6)
    assert m.shape == {"data": 2, "space": 3}
    assert len(m.data_devices) == 2 and len(m.space_devices) == 3


def test_run_each_runs_the_shards_at_once():
    """Each shard runs on a thread of its own, in the caller's inference
    mode: a barrier that all three shards must reach before any goes on
    passes only when they run together. A shard's error is raised, not the
    other shards' broken ``StatSync`` barrier."""
    barrier = threading.Barrier(3, timeout=60)

    def together(i, dev, x):
        barrier.wait()
        return x * i, torch.is_inference_mode_enabled()

    with torch.inference_mode():
        out = tmesh.run_each(together, [CPU] * 3, [[torch.ones(2)]] * 3)
    assert [float(y.sum()) for y, _ in out] == [0.0, 2.0, 4.0]
    assert all(mode for _, mode in out)

    def one_fails(i, dev):
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return tmesh.shared_sum()(torch.ones(1))

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        tmesh.run_each(one_fails, [CPU] * 3, [[]] * 3, tmesh.StatSync(3))


def test_batched_scorer_matches_jax():
    spec, params, state, model = _pickers(0)
    batch = np.random.default_rng(0).normal(size=(4, 96, 96)).astype(np.float32)
    want = np.asarray(jmesh.make_batched_scorer(spec, params, state, _jmesh(4, 1),
                                                precision="highest")(jnp.asarray(batch)))
    got = tmesh.make_batched_scorer(model, tmesh.make_mesh(4, 1, [CPU] * 4))(batch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 8])
def test_halo_dense_scorer_matches_jax(n):
    spec, params, state, model = _pickers(1)
    image = np.random.default_rng(n).normal(size=(n * 48, 120)).astype(np.float32)
    want = np.asarray(jmesh.make_halo_dense_scorer(spec, params, state, _jmesh(1, n),
                                                   precision="highest")(jnp.asarray(image)))
    got = tmesh.make_halo_dense_scorer(model, tmesh.make_mesh(1, n, [CPU] * n))(image)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        whole = model(torch.from_numpy(image)[None])[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="needs >= 35 rows per shard"):
        tmesh.make_halo_dense_scorer(model, tmesh.make_mesh(1, n, [CPU] * n))(image[: n * 20])


@pytest.mark.parametrize("arch,shape,n,halo", [
    ("affine", (8 * 32, 128), 8, 16),
    ("unet-small", (4 * 64, 128), 4, 32),
    ("unet3d", (2 * 32, 32, 32), 2, 16),
])
def test_halo_denoiser_matches_jax(arch, shape, n, halo):
    if arch == "unet3d":
        meta, params = jnew_denoiser("unet", nf=4, base_width=7, dims=3, seed=0)
    else:
        meta, params = jload_denoiser(arch)
    params = jax.tree_util.tree_map(np.asarray, params)
    image = np.random.default_rng(3).normal(2.0, 3.0, shape).astype(np.float32)
    want = np.asarray(jmesh.make_halo_denoiser(meta, params, _jmesh(1, n), halo=halo)(
        jnp.asarray(image)))
    model = denoiser_from_numpy(meta, params)
    got = tmesh.make_halo_denoiser(model, tmesh.make_mesh(1, n, [CPU] * n), halo=halo)(image)
    assert got.shape == image.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * image.std())
    if arch == "affine":  # pool-free: the halo route is the whole-image route
        mu, std = image.mean(), image.std()
        with torch.no_grad():
            whole = model(torch.from_numpy((image - mu) / std)[None, None])[0, 0] * std + mu
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-5 * image.std())


def test_unet_halo_bound_covers_jax():
    """The bundled ``unet`` through JAX's halo denoiser against its
    whole-image route, on a synthetic micrograph (``make_ctf_micrograph``,
    the kind chip_smoke.py denoises) of 1024^2, at the halo the commands
    use (256 rows) on 2 and 4 shards: the root mean square of the
    difference over the input's std is the bound chip_smoke.py holds the
    port's halo route to at 4096^2. The image's top and bottom edges make
    the difference (there the zero apron is not the whole image's
    per-layer zero padding; 2 and 4 shards differ alike), so its mean
    square falls as the image grows, where its largest value does not
    (0.407 at 1024^2, 0.423 at 2048^2)."""
    from topaz_tpu_torch.utils.synthetic import make_ctf_micrograph

    meta, params = jload_denoiser("unet")
    image, _ = make_ctf_micrograph(np.random.default_rng(0), size=1024, n_particles=5)
    mu, std = image.mean(), image.std()
    whole = np.asarray(japply_fn_for(meta)(params, jnp.asarray((image - mu) / std)[None, :, :, None],
                                           dims=2))[0, :, :, 0] * std + mu
    rms = []
    for n in (2, 4):
        halo_out = np.asarray(jmesh.make_halo_denoiser(meta, params, _jmesh(1, n), halo=256)(
            jnp.asarray(image)))
        rms.append(float(np.sqrt(np.mean(((halo_out - whole) / std) ** 2))))
    assert 0.005 < max(rms) <= chip_smoke.UNET_HALO_TOL, rms


def _crops(seed, B, width):
    rng = np.random.default_rng(seed)
    crops = rng.normal(size=(B, width, width)).astype(np.float32)
    return crops, (np.arange(B) % 4 == 0).astype(np.float32)


def _params_close(got, want):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-5, atol=1e-8,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("method", ["GE-binomial", "PN"])
def test_dp_train_step_matches_jax_and_one_device(method, bn):
    """With batch norm the statistics are the whole batch's, over the four
    shards, as in JAX's one program over its mesh: the weights and the
    running statistics both match."""
    spec, params, state, model = _pickers(2, bn=bn)
    crops, labels = _crops(0, 8, spec.width)
    pi = 0.05

    opt = jtrainer.make_optimizer(2e-4)
    jstep = jmesh.make_dp_train_step(spec, j_loss_fn(method, pi)[0], opt, mesh=_jmesh(4, 1))
    jnew, jm = jstep(jtrainer.init_train_state(spec, params, state, opt, pi), crops, labels)
    want = jax.tree_util.tree_map(np.asarray, jnew.params)
    want_state = jax.tree_util.tree_map(np.asarray, jnew.model_state)

    tstate = init_train_state(model, pi, lr=2e-4)
    step = tmesh.make_dp_train_step(t_loss_fn(method, pi)[0],
                                    tmesh.make_mesh(4, 1, [CPU] * 4))
    tm = step(tstate, torch.from_numpy(crops), torch.from_numpy(labels))
    assert sorted(tm) == sorted(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    got, got_state = tfactory.picker_to_numpy(model)
    _params_close(got, want)
    _params_close(got_state, want_state)

    one = tfactory.picker_from_numpy(t_spec("resnet8", units=4, bn=bn), params, state)
    ostate = init_train_state(one, pi, lr=2e-4)
    make_train_step(t_loss_fn(method, pi)[0])(ostate, torch.from_numpy(crops),
                                              torch.from_numpy(labels))
    one_params, one_state = tfactory.picker_to_numpy(one)
    _params_close(got, one_params)
    _params_close(got_state, one_state)


def test_denoise_with_devices_matches_jax():
    """``Denoise`` with four devices: a whole image through the halo route
    (JAX's ``_apply_halo`` rules: 250 rows padded by edge rows to 4 shards
    of 63, a 63-row halo) and a frame batch split over the data mesh,
    against the JAX package's ``Denoise`` over 4 of its devices; within
    1e-4 x std."""
    from topaz_tpu.denoise import Denoise as JDenoise
    from topaz_tpu_torch.denoise import Denoise

    jd = JDenoise("unet-small", devices=jax.devices()[:4])
    td = Denoise("unet-small", device="cpu", devices=[CPU] * 4)
    rng = np.random.default_rng(5)
    image = rng.normal(1.0, 2.0, (250, 96)).astype(np.float32)
    want = np.asarray(jd.denoise(image))
    got = td.denoise(image).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * image.std())
    frames = rng.normal(0.0, 1.0, (4, 64, 64)).astype(np.float32)
    want = np.asarray(jd.denoise_batch(frames))
    got = td.denoise_batch(frames)
    assert td.last_route == "batched"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * frames.std())


def test_denoise_bf16_with_devices_takes_the_halo_route_in_bf16():
    """``Denoise(dtype="bf16")`` with two devices denoises a whole image
    through the halo route with its bfloat16 model: the output is the halo
    denoiser's over that model, bit for bit, differs from the float32
    route's, and is within 4e-3 x std (bfloat16's unit roundoff, 2^-8) of
    the JAX package's bf16 ``Denoise`` over two devices."""
    from topaz_tpu.denoise import Denoise as JDenoise
    from topaz_tpu_torch.denoise import Denoise

    image = np.random.default_rng(5).normal(1.0, 2.0, (256, 96)).astype(np.float32)
    bf16 = Denoise("unet-small", device="cpu", dtype="bf16", devices=[CPU] * 2)
    got = bf16.denoise(image)
    assert got.dtype == torch.float32 and len(bf16._halo_fns) == 1
    halo = tmesh.make_halo_denoiser(bf16.model, tmesh.make_mesh(1, 2, [CPU] * 2), halo=128)
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    np.testing.assert_array_equal(got.numpy(), halo(image).numpy())
    f32 = Denoise("unet-small", device="cpu", devices=[CPU] * 2).denoise(image)
    assert float((got - f32).abs().max()) > 0
    want = np.asarray(JDenoise("unet-small", devices=jax.devices()[:2], dtype="bf16")
                      .denoise(image))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-3 * image.std())


def test_denoise3d_patches_with_devices_match_one_device():
    """``Denoise3D`` with two devices shares a resident volume's patches out
    over them, each device holding the volume: equal to one device's
    patches within 1e-5 x std."""
    from topaz_tpu_torch.denoise import Denoise3D

    vol = np.random.default_rng(6).normal(size=(40, 36, 36)).astype(np.float32)
    one = Denoise3D.from_arch("unet", device="cpu", nf=4, base_width=7, seed=0)
    two = Denoise3D.from_arch("unet", device="cpu", devices=[CPU, CPU], nf=4, base_width=7,
                              seed=0)
    want = one.denoise(vol, patch_size=16, padding=8, batch_size=3, verbose=False)
    got = two.denoise(vol, patch_size=16, padding=8, batch_size=3, verbose=False)
    assert one.last_route == "resident" and two.last_route == "resident"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * vol.std())


@pytest.mark.parametrize("devices", [2, 3])
def test_denoise3d_streamed_patches_with_devices_match_one_device(devices):
    """With the resident route off, ``Denoise3D`` streams its patch batches
    split over the devices (the batch grown to a multiple of their count):
    equal to one device's streamed patches within 1e-5 x std."""
    from topaz_tpu_torch.denoise import Denoise3D

    vol = np.random.default_rng(7).normal(size=(40, 36, 36)).astype(np.float32)
    one = Denoise3D.from_arch("unet", device="cpu", nf=4, base_width=7, seed=0)
    many = Denoise3D.from_arch("unet", device="cpu", devices=[CPU] * devices, nf=4,
                               base_width=7, seed=0)
    kw = dict(patch_size=16, padding=8, batch_size=1, verbose=False, device_resident=False)
    want = one.denoise(vol, **kw)
    got = many.denoise(vol, **kw)
    assert one.last_route == "streaming" and many.last_route == "streaming"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * vol.std())


@pytest.mark.parametrize("devices", [3, 4])
def test_denoise3d_resident_share_with_devices_spans_and_counts(devices):
    """Each device of a resident split records its upload and fetch and its
    share of the patches (27 patches of 16 over 3 or 4 devices); the
    volume counts once, as resident; equal to one device's output."""
    from topaz_tpu_torch import denoise
    from topaz_tpu_torch.denoise import Denoise3D
    from topaz_tpu_torch.utils import profiling

    vol = np.random.default_rng(8).normal(size=(40, 36, 36)).astype(np.float32)
    one = Denoise3D.from_arch("unet", device="cpu", nf=4, base_width=7, seed=0)
    many = Denoise3D.from_arch("unet", device="cpu", devices=[CPU] * devices, nf=4,
                               base_width=7, seed=0)
    want = one.denoise(vol, patch_size=16, padding=8, verbose=False)
    profiling.reset()
    before = (denoise.resident_volumes, denoise.patches_denoised)
    got = many.denoise(vol, patch_size=16, padding=8, verbose=False)
    assert many.last_route == "resident"
    assert (denoise.resident_volumes - before[0], denoise.patches_denoised - before[1]) == (1, 27)
    assert [profiling.count(f"denoise3d/{n}") for n in ("upload", "patch", "unet", "fetch")] \
        == [devices, 27, 27, devices]
    threads = {r.thread for r in profiling.records("denoise3d/patch")}
    assert len(threads) == devices  # a thread a device
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * vol.std())
    profiling.reset()


def test_denoiser_training_with_devices_matches_one_device(tmp_path):
    """noise2noise training with batches split over two devices takes the
    one-device steps: weights within 1e-5 relative (atol 1e-7) after two
    epochs of L2 with SGD (momentum 0.9, nesterov). SGD's update is linear
    in the gradient, so the two differ by float32 sum order alone; Adam's
    first updates are +-lr wherever a gradient is near 0, whatever its
    size, and would turn that rounding into lr-sized differences."""
    from topaz_tpu_torch.denoise import train_denoiser
    from topaz_tpu_torch.models.denoise_factory import new_denoiser

    rng = np.random.default_rng(7)
    pairs = [rng.normal(size=(2, 8, 48, 48)).astype(np.float32) for _ in range(2)]

    class Sampler:
        def __init__(self, data):
            self.data = data

        def batches(self, batch_size, shuffle=True):
            for a, b in self.data:
                yield a, b

    out = []
    for devices in (None, [CPU, CPU]):
        model = new_denoiser("unet-small", nf=4, seed=0)
        train_denoiser(model, Sampler(pairs), Sampler(pairs[:1]), optim="sgd", lr=1e-2,
                       batch_size=8, num_epochs=2, verbose=False, devices=devices)
        out.append([p.detach().numpy().copy() for p in model.parameters()])
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def test_segment_with_devices_matches_whole_image(tmp_path):
    """``segment`` over four devices scores each whole 2D image in row
    shards (the 150-row image padded to 4 shards of 38 rows >= the 35-row
    halo; the 100-row one in 2 shards): the whole-image map within 1e-4."""
    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.segment import score_maps

    paths = []
    for i, shape in enumerate([(150, 90), (100, 80)]):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], np.random.default_rng(i).normal(size=shape).astype(np.float32))
    got = dict(score_maps("resnet8_u32", paths, devices=[CPU] * 4))
    want = dict(score_maps("resnet8_u32", paths, device="cpu"))
    for p in paths:
        assert got[p].shape == want[p].shape
        np.testing.assert_allclose(got[p], want[p], rtol=1e-4, atol=1e-4)


def test_batched_normalize_over_a_mesh_matches_one_device(tmp_path):
    """``normalize -d -2``'s path: the GMM fits of a batch split over a data
    mesh of two devices write the one-device batch's images (within 1e-6;
    each image's EM is the same computation) and metadata."""
    import json

    from topaz_tpu_torch.io import mrc
    from topaz_tpu_torch.preprocess import normalize_images_batched

    rng = np.random.default_rng(11)
    paths = []
    for i, shape in enumerate([(96, 120), (128, 122), (120, 128)]):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], (rng.normal(size=shape) + 3).astype(np.float32))
    out = {}
    for tag, kw in (("one", dict(batch_size=2, device="cpu")),
                    ("mesh", dict(batch_size=0, mesh=tmesh.make_mesh(2, 1, [CPU] * 2)))):
        normalize_images_batched(paths, str(tmp_path / tag), metadata=True, **kw)
        out[tag] = {i: (mrc.read(str(tmp_path / tag / f"m{i}.mrc"))[0],
                        json.load(open(tmp_path / tag / f"m{i}.metadata.json")))
                    for i in range(3)}
    for i in range(3):
        np.testing.assert_allclose(out["mesh"][i][0], out["one"][i][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["mesh"][i][1]["mu"], out["one"][i][1]["mu"], rtol=1e-6)
