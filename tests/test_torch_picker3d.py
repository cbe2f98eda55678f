"""The port's 3D pickers against the JAX package's, on the CPU.

Parameters drawn by the JAX package's ``init_picker`` (batchnorm statistics
redrawn at random so that they matter) cross to the port as numpy through
``picker_from_numpy``; the same seeded volumes go through both. Dense
scores, whole and tiled (``classify_patches_3d``), agree within atol 1e-4,
rtol 1e-4 (float32 convolutions sum in another order in XLA and PyTorch).
A 3D ``.npz`` written by either package loads in the other with the same
weights, and ``extract --dims 3`` writes the same picks, ``z_coord``
included, as the JAX CLI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu.models import factory as jfactory
from topaz_tpu.models import tiling as jtiling
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models import tiling as ttiling
from topaz_tpu_torch.models.picker import make_picker_spec
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _numpy_tree(tree, rng):
    def leaf(path, v):
        v = np.asarray(v, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "'mean'" in name or "'bias'" in name:
            return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(arch, units=4, seed=1, **kw):
    rng = np.random.default_rng(seed)
    spec, params, state = jfactory.new_picker(arch, units=units, seed=seed, dims=3, **kw)
    params, state = _numpy_tree(params, rng), _numpy_tree(state, rng)
    model = tfactory.picker_from_numpy(make_picker_spec(arch, units=units, dims=3, **kw),
                                       params, state)
    return spec, params, state, model


def _jax_dense(spec, params, state, x):
    y, _ = apply_picker(spec, params, jnp.asarray(x), state=state, dense=True)
    return np.asarray(y)


@pytest.mark.parametrize("arch,kw", [("resnet8", {}),
                                     ("resnet8", {"pooling": "max", "bn": True}),
                                     ("conv31", {"pooling": "avg", "bn": True})])
def test_dense_3d_scores_match_jax(arch, kw):
    spec, params, state, model = _pair(arch, **kw)
    assert model.classifier_w.shape == (1, spec.latent_dim, 1, 1, 1)
    x = np.random.default_rng(2).normal(size=(1, 10, 12, 14)).astype(np.float32)
    want = _jax_dense(spec, params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_classify_patches_3d_matches_jax_and_whole_volume():
    """Tiles of 6^3 in batches of 3 (the last one ragged) over a volume
    that is no multiple of the tile (conv31: a 15-voxel halo keeps the
    tiles small)."""
    spec, params, state, model = _pair("conv31")
    x = np.random.default_rng(3).normal(size=(10, 12, 14)).astype(np.float32)
    want = jtiling.classify_patches_3d(spec, params, state, x, patch_size=6, batch_size=3)
    got = ttiling.classify_patches_3d(model, x, patch_size=6, batch_size=3)
    assert got.device.type == "cpu" and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():
        whole = model(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got.numpy(), whole, **TOL)


def test_3d_checkpoints_load_in_both_packages(tmp_path):
    spec, params, state, model = _pair("resnet8", bn=True)
    port_path = str(tmp_path / "port3d.npz")
    tfactory.save_picker(port_path, model)
    jspec, jparams, jstate = jfactory.load_picker(port_path)
    assert jspec == spec
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(jstate), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jax_path = str(tmp_path / "jax3d.npz")
    jfactory.save_picker(jax_path, spec, params, state)
    back = tfactory.load_picker(jax_path, device="cpu")
    assert back.spec.dims == 3 and back.spec.width == spec.width
    for a, b in zip(back.state_dict().values(), model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    args.func(args)


def _table(path):
    with open(path) as f:
        header = next(f).rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return header, [r[:-1] for r in rows], np.array([float(r[-1]) for r in rows])


def test_extract_dims3_matches_the_jax_cli(tmp_path):
    """A conv31 picker (units 4) saved by the port, one 20 x 24 x 28 volume
    of planted blobs, scored in the CLI's 96^3 tiles: identical picks
    (x, y, z) in the same order, scores within 1e-4."""
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(20, 24, 28)).astype(np.float32)
    zz, yy, xx = np.mgrid[:20, :24, :28]
    for cz, cy, cx in ((5, 6, 7), (14, 16, 20), (10, 18, 6)):
        vol -= 3 * np.exp(-((zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    path = str(tmp_path / "tomo.mrc")
    mrc.write(path, vol.astype(np.float32))
    _, _, _, model = _pair("conv31")
    ckpt = str(tmp_path / "picker3d.npz")
    tfactory.save_picker(ckpt, model)
    argv = ["extract", "--dims", "3", "-m", ckpt, "-r", "3", "-t", "-100", path]
    _jax_cli(argv + ["-o", str(tmp_path / "jax.txt")])
    tmain(argv + ["-d", "cpu", "-o", str(tmp_path / "port.txt")])
    jheader, jrows, jscores = _table(tmp_path / "jax.txt")
    theader, trows, tscores = _table(tmp_path / "port.txt")
    assert theader == jheader == ["image_name", "x_coord", "y_coord", "z_coord", "score"]
    assert len(trows) >= 10
    assert trows == jrows
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fmt", ["coord", "star"])
def test_extract_dims3_score_volume_per_micrograph_bytes_equal(tmp_path, fmt):
    """``-m none --dims 3``: a score volume straight into 3D NMS; the
    per-micrograph file, ``z_coord`` column included, is byte-equal to the
    JAX CLI's."""
    vol = np.round(np.random.default_rng(5).normal(size=(12, 16, 18)) * 4).astype(np.float32)
    path = str(tmp_path / "scores.mrc")
    mrc.write(path, vol)
    out = {}
    for tag in ("jax", "port"):
        os.makedirs(tmp_path / tag)
        argv = ["extract", "--dims", "3", "-m", "none", "-r", "2", "-t", "0",
                "--per-micrograph", "--format", fmt, "-o", str(tmp_path / tag), path]
        if tag == "jax":
            _jax_cli(argv)
        else:
            tmain(argv + ["-d", "cpu"])
        with open(tmp_path / tag / f"scores.{fmt}") as f:
            out[tag] = f.read()
    assert out["port"] == out["jax"]
    assert "z_coord" in out["port"] and len(out["port"].splitlines()) > 10
