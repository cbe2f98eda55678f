"""The port's ``MicrographPipeline`` against the JAX package's, on the CPU.

The five camera-like shapes of tests/test_pipeline.py (two shape buckets at
``bucket_step`` 64), with planted particles, made with numpy from a seed,
go through both pipelines at batch 4. Picks must be identical in
coordinates and order, scores within rtol 1e-4 / atol 1e-5 (float32
convolution and EM sums run in other orders), and the census of programs
equal. Then: scale 2 with device prep and with host prep, the histogram EM,
the ``fcnn`` denoise arm (denoised pixels within 1e-4 x std) with a dead
frame sharing a batch, and ``skip_errors``."""

import warnings

import numpy as np
import pytest
import torch

from topaz_tpu.pipeline import MicrographPipeline as JaxPipeline
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.pipeline import MicrographPipeline
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(120, 128), (128, 122), (126, 128), (96, 120), (160, 128)]
BASE = dict(model="resnet8_u32", scale=1, radius=6, threshold=1.0, bucket_step=64)


def _write(path, rng, shape, peaks):
    x = rng.normal(0, 1, shape).astype(np.float32)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for cy, cx in peaks:
        x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2)).astype(np.float32)
    mrc.write(str(path), x)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(42)
    paths = [_write(d / f"g{i}.mrc", rng, s,
                    [(s[0] // 3, s[1] // 3), (2 * s[0] // 3, 2 * s[1] // 3), (s[0] // 4, 3 * s[1] // 4)])
             for i, s in enumerate(SHAPES)]
    dead = str(d / "dead.mrc")
    mrc.write(dead, np.full((96, 120), 7.5, np.float32))
    return paths, dead


def _run(cls, paths, batch_size=4, **kw):
    pipe = cls(**{**BASE, **kw})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = list(pipe.process(paths, batch_size=batch_size))
    return pipe, out, [str(w.message) for w in rec]


def _assert_same_picks(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2], err_msg=g[0])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-4, atol=1e-5, err_msg=g[0])


def test_five_shapes_match_jax(files):
    paths, _ = files
    jpipe, want, _ = _run(JaxPipeline, paths)
    tpipe, got, _ = _run(MicrographPipeline, paths, device="cpu")
    assert tpipe.num_programs == jpipe.num_programs == {"main": 2, "prep": 0}
    assert all(len(r[1]) >= 2 for r in got)
    assert all(np.all(np.diff(r[1]) <= 0) for r in got)
    _assert_same_picks(got, want)


@pytest.fixture(scope="module")
def jax_scale2(files):
    paths, _ = files
    return _run(JaxPipeline, paths, scale=2, radius=3)


@pytest.mark.parametrize("host_downsample", [False, True])
def test_scale_two_matches_jax(files, jax_scale2, host_downsample):
    """Device prep (one downsample per geometry, then embedded) and host
    prep (scipy in the loader threads) both match JAX's device prep."""
    paths, _ = files
    jpipe, want, _ = jax_scale2
    tpipe, got, _ = _run(MicrographPipeline, paths, scale=2, radius=3,
                         host_downsample=host_downsample, num_workers=2, device="cpu")
    assert tpipe.num_programs == {"main": 2, "prep": 0 if host_downsample else 5}
    assert jpipe.num_programs == {"main": 2, "prep": 5}
    assert all(len(r[1]) >= 1 for r in got)
    _assert_same_picks(got, want)


def test_histogram_em_matches_jax(files):
    paths, _ = files
    _, want, _ = _run(JaxPipeline, paths[:3], bins=4096)
    _, got, _ = _run(MicrographPipeline, paths[:3], bins=4096, device="cpu")
    _assert_same_picks(got, want)


@pytest.fixture(scope="module")
def denoised(files):
    """Both pipelines with the fcnn denoise arm; the dead frame shares a
    batch with the (96, 120) and (120, 128) images."""
    paths, dead = files
    order = [paths[3], dead, paths[0]] + paths[1:3] + paths[4:]
    return (_run(JaxPipeline, order, denoise_model="fcnn"),
            _run(MicrographPipeline, order, denoise_model="fcnn", device="cpu"), dead)


def test_denoise_arm_matches_jax(denoised):
    (_, want, _), (_, got, _), dead = denoised
    _assert_same_picks(got, want)
    for g, w in zip(got, want):
        assert g[3].shape == w[3].shape and np.isfinite(g[3]).all()
        if g[0] != dead:
            np.testing.assert_allclose(g[3], w[3], atol=1e-4 * w[3].std(), rtol=0,
                                       err_msg=g[0])


def test_bf16_denoise_arm_keeps_f32_picks(denoised, files):
    """``dtype="bf16"`` runs the U-Net in bfloat16 with float32 out; scoring
    and NMS stay float32, so picks are those of the float32 run, and the
    denoised images stay within the JAX package's bf16 bound (mean abs
    difference / mean |y_f32| < 0.05)."""
    _, (_, f32, _), dead = denoised
    paths = [r[0] for r in f32 if r[0] != dead][:2]
    _, got, _ = _run(MicrographPipeline, paths, denoise_model="fcnn", dtype="bf16",
                     device="cpu")
    want = {r[0]: r for r in f32}
    for g in got:
        w = want[g[0]]
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[3].dtype == np.float32
        assert 0 < np.mean(np.abs(g[3] - w[3])) / np.mean(np.abs(w[3])) < 0.05


def test_dead_frame_in_a_shared_batch(denoised):
    (_, want, jmsgs), (_, got, msgs), dead = denoised
    assert any("constant image" in m and "dead.mrc" in m for m in msgs)
    assert any("constant image" in m and "dead.mrc" in m for m in jmsgs)
    (_, s, c, d), = [r for r in got if r[0] == dead]
    assert len(s) == len(c) == 0
    np.testing.assert_array_equal(d, np.full((96, 120), 7.5, np.float32))
    assert sum(len(r[1]) for r in got) > 0


def test_skip_errors(files, tmp_path):
    """``skip_errors``: unreadable or corrupt files warn and are skipped and
    the good ones keep their picks; without it the first bad file raises."""
    paths, _ = files
    good = paths[:2]
    truncated = tmp_path / "trunc.mrc"
    with open(good[0], "rb") as f:
        truncated.write_bytes(f.read()[:700])  # cut inside the header
    garbage = tmp_path / "garbage.mrc"
    with open(good[1], "rb") as f:
        data = bytearray(f.read())
    data[0:8] = (2**31 - 1).to_bytes(4, "little") * 2  # absurd nx, ny
    garbage.write_bytes(bytes(data))
    bad_paths = [good[0], str(truncated), good[1], str(garbage)]

    with pytest.raises(Exception):
        _run(MicrographPipeline, bad_paths, batch_size=2, device="cpu")
    _, got, msgs = _run(MicrographPipeline, bad_paths, batch_size=2, device="cpu",
                        skip_errors=True)
    assert [r[0] for r in got] == good
    skipped = [m for m in msgs if "skipped" in m]
    assert any("trunc.mrc" in m for m in skipped) and any("garbage.mrc" in m for m in skipped)
    _, solo, _ = _run(MicrographPipeline, good, batch_size=2, device="cpu")
    _assert_same_picks(got, solo)


def test_no_mesh_and_no_fallback(files):
    """Over a 2 x 2 (data x space) mesh that repeats the CPU (each batch
    split in two, each image scored in two row shards with halos) the
    pipeline gives the one-device picks; with no GPU and no device named it
    raises instead of running on the CPU."""
    from topaz_tpu_torch.parallel.mesh import make_mesh

    paths, _ = files
    mesh = make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4)
    pipe, got, _ = _run(MicrographPipeline, paths, mesh=mesh)
    assert pipe.device == torch.device("cpu")
    _, solo, _ = _run(MicrographPipeline, paths, device="cpu")
    _assert_same_picks(got, solo)
    if torch.cuda.is_available():
        return
    from topaz_tpu_torch.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        MicrographPipeline()
