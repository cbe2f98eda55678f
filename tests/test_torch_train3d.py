"""3D picker training (``train --dims 3``, ``--augment-3d``) of the port
against the JAX package's.

With the same files, seed and positive counts both samplers draw the same
3D windows and labels, bit for bit (host gather, and the port's windows cut
on the device from the resident tomograms); given the same draws the 3D
augmentation is bit-equal. One 3D step (conv31, units 4) runs with plain
SGD at lr 1 in both packages, so each parameter's change is its gradient:
metrics and gradients agree to rtol 1e-3, atol 1e-5 (x the leaf's largest
gradient), as do the TSV rows of a whole run (``test_torch_train_run.py``'s
tolerance: float32 convolutions and their gradients sum in other orders in
XLA and PyTorch, and Adam carries that forward)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from topaz_tpu.cli.commands import train as jcli
from topaz_tpu.io import mrc
from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import init_picker as j_init_picker
from topaz_tpu.models.picker import make_picker_spec as j_spec
from topaz_tpu.train import trainer as jtrainer
from topaz_tpu.train.augment import augment_crops_3d as j_augment_crops_3d
from topaz_tpu.train.data import CropSampler as JSampler
from topaz_tpu.train.methods import make_loss_fn as j_loss_fn
from topaz_tpu.training import train_from_args as j_train_from_args
from topaz_tpu_torch.cli.commands import train as tcli
from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models.picker import make_picker_spec as t_spec
from topaz_tpu_torch.train.augment import transform_crops_3d
from topaz_tpu_torch.train.data import CropSampler as TSampler
from topaz_tpu_torch.train.data import ResidentVolumes
from topaz_tpu_torch.train.methods import make_loss_fn as t_loss_fn
from topaz_tpu_torch.train.trainer import init_train_state, make_train_step
from topaz_tpu_torch.training import make_model_from_args
from topaz_tpu_torch.training import train_from_args as t_train_from_args
from topaz_tpu_torch.training import train_model as t_train_model
from test_torch_train_run import _assert_rows_close, _rows
from torch_threads import one_torch_thread  # noqa: F401


def _tomograms(tmp_path, shapes=((40, 80, 80), (32, 64, 72)), n_blobs=8):
    """Tomograms of noise with dark blobs; returns (paths, targets table)."""
    rng = np.random.default_rng(0)
    (tmp_path / "tomos").mkdir()
    paths, rows = [], []
    for i, shape in enumerate(shapes):
        x = rng.normal(0, 1, shape).astype(np.float32)
        zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
        for _ in range(n_blobs):
            c = [int(rng.integers(0, n)) for n in shape]
            x -= 2.5 * np.exp(-((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
                              / 8.0).astype(np.float32)
            rows.append((f"tomo{i}", c[2], c[1], c[0]))
        paths.append(str(tmp_path / "tomos" / f"tomo{i}.mrc"))
        mrc.write(paths[-1], x)
    table = pd.DataFrame(rows, columns=["image_name", "x_coord", "y_coord", "z_coord"])
    table.to_csv(tmp_path / "targets.txt", sep="\t", index=False)
    return paths, table


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("split", ["pn", "pu"])
def test_3d_sampler_draws_the_jax_windows_bit_for_bit(tmp_path, rotate, split):
    paths, table = _tomograms(tmp_path)
    coords = Coordinates(table.image_name.values, table.x_coord.values,
                         table.y_coord.values, z_coord=table.z_coord.values)
    kw = dict(radius=3, split=split, rotate=rotate, seed=5, dims=3)
    jax_sampler = JSampler(paths, table, 31, **kw)
    host = TSampler(paths, coords, 31, **kw)
    positions = TSampler(paths, coords, 31, **kw)
    volumes = ResidentVolumes(positions, "cpu")
    assert (host.raw_size_z, host.raw_size) == (31, 45 if rotate else 31)
    assert not host.augment and host.num_pixels == jax_sampler.num_pixels
    for n_pos in (0, 3, 12):
        want, want_labels = jax_sampler.sample_batch(12, n_pos)
        got, labels = host.sample_batch(12, n_pos)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(labels, want_labels)
        *where, labels = positions.sample_positions(12, n_pos)
        np.testing.assert_array_equal(volumes.gather(*where).numpy(), want)
        np.testing.assert_array_equal(labels, want_labels)


@pytest.mark.parametrize("size,out", [(45, 31), (31, 31), (11, 7)])
def test_3d_transform_is_bit_equal_given_the_same_draws(size, out):
    rng = np.random.default_rng(size)
    crops = rng.normal(size=(5, out, size, size)).astype(np.float32)
    key = jax.random.PRNGKey(size)
    want = np.asarray(j_augment_crops_3d(jnp.asarray(crops), key, out))
    # the draws augment_crops_3d makes from its key
    k_angle, k_h, k_v, k_z = jax.random.split(key, 4)
    angles = np.asarray(jax.random.uniform(k_angle, (5,), minval=0.0, maxval=360.0))
    flips = [torch.from_numpy(np.asarray(jax.random.bernoulli(k, 0.5, (5,))))
             for k in (k_h, k_v, k_z)]
    got = transform_crops_3d(torch.from_numpy(crops), out, torch.from_numpy(angles), *flips)
    np.testing.assert_array_equal(got.numpy(), want)
    # without rotation or flips: the center crop alone
    plain = np.asarray(j_augment_crops_3d(jnp.asarray(crops), key, out, rotate=False,
                                          flip=False))
    np.testing.assert_array_equal(
        transform_crops_3d(torch.from_numpy(crops), out, None, None, None, None).numpy(), plain)


def test_3d_step_matches_jax():
    """Loss, metrics and gradients of one 3D step, conv31 at units 4 with
    batchnorm, GE-binomial."""
    spec = j_spec("conv31", units=4, bn=True, dims=3)
    params, state = j_init_picker(spec, jax.random.PRNGKey(0))
    params, state = (jax.tree_util.tree_map(np.asarray, t) for t in (params, state))
    rng = np.random.default_rng(0)
    crops = (rng.normal(size=(6, 31, 31, 31)) + rng.normal(size=(6, 1, 1, 1))).astype(np.float32)
    labels = np.array([1, 0, 0, 1, 0, 0], dtype=np.float32)
    pi = 0.1
    opt = jtrainer.make_optimizer(1.0, "sgd")
    jstep = jtrainer.make_train_step(spec, j_loss_fn("GE-binomial", pi)[0], opt)
    new, jm = jstep(jtrainer.init_train_state(spec, params, state, opt, pi),
                    jnp.asarray(crops), jnp.asarray(labels))

    model = tfactory.picker_from_numpy(t_spec("conv31", units=4, bn=True, dims=3), params, state)
    tstate = init_train_state(model, pi, lr=1.0, optim="sgd")
    tm = make_train_step(t_loss_fn("GE-binomial", pi)[0])(
        tstate, torch.from_numpy(crops), torch.from_numpy(labels))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, atol=1e-5, err_msg=k)
    after, after_state = tfactory.picker_to_numpy(model)
    want_after = jax.tree_util.tree_map(np.asarray, new.params)
    for (path, p0), a, b in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves(after),
                                jax.tree_util.tree_leaves(want_after)):
        want = p0 - b
        scale = max(float(np.abs(want).max()), 1e-8)
        np.testing.assert_allclose(p0 - a, want, rtol=1e-3, atol=1e-5 * max(1.0, scale),
                                   err_msg=jax.tree_util.keystr(path))
    # batchnorm's running statistics (train mode) agree too
    for a, b in zip(jax.tree_util.tree_leaves(after_state),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                     new.model_state))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _argv(tmp_path, *extra):
    return ["--train-images", str(tmp_path / "tomos"), "--train-targets",
            str(tmp_path / "targets.txt"), "--dims", "3", "--minibatch-size", "8",
            "--minibatch-balance", "0.25", "-n", "20", *extra]


def test_3d_training_run_matches_jax(tmp_path):
    """Both runs start from one 3D checkpoint (no 3D weights are bundled,
    and the two packages draw fresh weights from different generators)."""
    _tomograms(tmp_path)
    spec, params, state = jfactory.new_picker("conv31", units=4, bn=True, dims=3, seed=3)
    jfactory.save_picker(str(tmp_path / "start.npz"), spec,
                         *(jax.tree_util.tree_map(np.asarray, t) for t in (params, state)))
    argv = _argv(tmp_path, "-m", str(tmp_path / "start.npz"), "--test-images", str(tmp_path / "tomos"), "--test-targets",
                 str(tmp_path / "targets.txt"), "--num-epochs", "2", "--epoch-size", "3")
    t_train_from_args(tcli.add_arguments().parse_args(
        argv + ["-d", "cpu", "--save-prefix", str(tmp_path / "port" / "m"),
                "-o", str(tmp_path / "port.tsv")]))
    j_train_from_args(jcli.add_arguments().parse_args(
        argv + ["--save-prefix", str(tmp_path / "jax" / "m"), "-o", str(tmp_path / "jax.tsv")]))
    got, want = (tmp_path / "port.tsv").read_text(), (tmp_path / "jax.tsv").read_text()
    _assert_rows_close(got, want)
    assert [r[2] for r in _rows(got)[1]] == ["train"] * 3 + ["test"] + ["train"] * 3 + ["test"]

    # each package's 3D checkpoint loads in the other
    jspec, jparams, _ = jfactory.load_picker(str(tmp_path / "port" / "m_epoch2.npz"))
    assert (jspec.dims, jspec.width) == (3, 31)
    pparams, _ = tfactory.picker_to_numpy(
        tfactory.load_picker(str(tmp_path / "jax" / "m_epoch2.npz"), device="cpu"))
    _, want_params, _ = jfactory.load_picker(str(tmp_path / "jax" / "m_epoch2.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(pparams), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-4)


def test_3d_training_with_augmentation_runs(tmp_path):
    _tomograms(tmp_path)
    out = io.StringIO()
    state = t_train_model(tcli.add_arguments().parse_args(_argv(
        tmp_path, "--augment-3d", "--no-pretrained", "-m", "conv31", "--units", "4",
        "--num-epochs", "1", "--epoch-size", "3", "-d", "cpu")), output=out)
    header, rows = _rows(out.getvalue())
    assert header[3:5] == ["loss", "ge_penalty"] and len(rows) == 3
    assert all(np.isfinite(float(v)) for r in rows for v in r[3:-1])
    assert state.model.spec.dims == 3


def test_3d_defaults_fail_in_jax_and_train_in_the_port(tmp_path, capsys):
    """The CLI defaults (resnet8, units 32, --pretrained) with --dims 3: the
    JAX package loads the 2D resnet8_u32 into the 3D run and its first step
    fails; the port warns that no 3D weights exist and trains fresh ones."""
    _tomograms(tmp_path, shapes=((24, 40, 40),), n_blobs=4)
    argv = _argv(tmp_path, "--num-epochs", "1", "--epoch-size", "1") + [
        "--minibatch-size", "2"]
    with pytest.raises(ValueError, match="too many values to unpack"):
        j_train_from_args(jcli.add_arguments().parse_args(argv))
    capsys.readouterr()

    args = tcli.add_arguments().parse_args(argv + ["-d", "cpu"])
    model = make_model_from_args(args, torch.device("cpu"))
    assert (model.spec.arch, model.spec.dims, model.spec.width) == ("resnet8", 3, 71)
    assert dict(model.spec.config)["units"] == 32
    out = io.StringIO()
    t_train_model(args, output=out)
    err = capsys.readouterr().err
    assert "WARNING: pretrained weights for resnet8_u32 unavailable; initializing randomly" in err
    header, rows = _rows(out.getvalue())
    assert len(rows) == 1 and all(np.isfinite(float(v)) for v in rows[0][3:-1])
