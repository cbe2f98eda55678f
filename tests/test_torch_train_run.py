"""Whole training runs of the port against the JAX package's, resume, and
the ``train`` CLI.

With the same seed and files both samplers draw the same crops, and both
runs start from the bundled ``resnet8_u32`` with dropout 0, so the TSV rows
of the two packages are comparable number by number: they agree to rtol
1e-3, atol 1e-5 (measured: 1e-5 to 5e-5 relative; float32 convolutions and
their gradients sum in other orders in XLA and PyTorch, and six Adam steps
carry that forward), and the checkpoints' weights to atol 1e-4. Resuming
mid-epoch in the port is bit-exact on the CPU."""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from topaz_tpu.cli.commands import train as jcli
from topaz_tpu.io import mrc
from topaz_tpu.models import factory as jfactory
from topaz_tpu.training import train_from_args as j_train_from_args
from topaz_tpu_torch.cli.commands import train as tcli
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch import training as ttraining
from topaz_tpu_torch.training import train_from_args as t_train_from_args
from topaz_tpu_torch.training import train_model as t_train_model
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(tmp_path, n_images=3, size=128, n_particles=6):
    rng = np.random.default_rng(0)
    (tmp_path / "mics").mkdir()
    rows = []
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n_images):
        x = rng.normal(0, 1, (size, size)).astype(np.float32)
        for _ in range(n_particles):
            cy, cx = rng.integers(15, size - 15, 2)
            x -= 2.5 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 32.0).astype(np.float32)
            rows.append(f"img{i}\t{cx}\t{cy}\n")
        mrc.write(str(tmp_path / "mics" / f"img{i}.mrc"), x)
    (tmp_path / "t.txt").write_text("image_name\tx_coord\ty_coord\n" + "".join(rows))
    return ["--train-images", str(tmp_path / "mics"), "--train-targets", str(tmp_path / "t.txt"),
            "--minibatch-size", "16", "--minibatch-balance", "0.25"]


def _rows(text):
    lines = text.strip().split("\n")
    return lines[0].split("\t"), [line.split("\t") for line in lines[1:]]


def _assert_rows_close(got, want):
    got_header, got_rows = _rows(got)
    want_header, want_rows = _rows(want)
    assert got_header == want_header
    assert len(got_rows) == len(want_rows)
    for g, w in zip(got_rows, want_rows):
        assert g[:3] == w[:3]
        for a, b in zip(g[3:], w[3:]):
            if b == "-":
                assert a == "-"
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("flags", [
    ["--test-images", "{d}/mics", "--test-targets", "{d}/t.txt", "-n", "15"],
    ["-k", "3", "--method", "GE-KL", "--pi", "0.2"],
])
def test_training_run_matches_jax(tmp_path, flags):
    argv = _dataset(tmp_path) + [f.format(d=tmp_path) for f in flags] + [
        "--num-epochs", "2", "--epoch-size", "3"]
    t_train_from_args(tcli.add_arguments().parse_args(
        argv + ["-d", "cpu", "--save-prefix", str(tmp_path / "port" / "m"),
                "-o", str(tmp_path / "port.tsv")]))
    j_train_from_args(jcli.add_arguments().parse_args(
        argv + ["--save-prefix", str(tmp_path / "jax" / "m"), "-o", str(tmp_path / "jax.tsv")]))
    got, want = (tmp_path / "port.tsv").read_text(), (tmp_path / "jax.tsv").read_text()
    _assert_rows_close(got, want)
    assert sum(r[2] == "test" for r in _rows(got)[1]) == 2

    # the port's checkpoint loads in the JAX package, next to its own
    jspec, jparams, _ = jfactory.load_picker(str(tmp_path / "jax" / "m_epoch2.npz"))
    pspec, pparams, _ = jfactory.load_picker(str(tmp_path / "port" / "m_epoch2.npz"))
    assert pspec == jspec
    for a, b in zip(jax_leaves(pparams), jax_leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def jax_leaves(tree):
    import jax

    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def test_resume_mid_epoch_is_bit_exact(tmp_path, monkeypatch):
    argv = _dataset(tmp_path, n_images=2) + [
        "-n", "10", "--epoch-size", "4", "--no-pretrained", "--units", "4", "--bn", "on",
        "--dropout", "0.2", "-d", "cpu"]
    parse = tcli.add_arguments().parse_args
    whole = io.StringIO()
    t_train_model(parse(argv + ["--num-epochs", "2", "--save-prefix", str(tmp_path / "a" / "m")]),
                  output=whole)

    # a run cut after step 3 of epoch 1: keep the mid-epoch state it wrote
    save = ttraining.save_train_state

    def save_and_keep(path, state, epoch, it, steps_in_epoch, **kw):
        save(path, state, epoch, it, steps_in_epoch, **kw)
        if steps_in_epoch == 3:
            shutil.copy(path, tmp_path / "mid.npz")

    monkeypatch.setattr(ttraining, "save_train_state", save_and_keep)
    t_train_model(parse(argv + ["--num-epochs", "1", "--save-interval-steps", "3",
                                "--save-prefix", str(tmp_path / "b" / "m")]), output=io.StringIO())
    resumed = io.StringIO()
    t_train_model(parse(argv + ["--num-epochs", "2", "--resume", str(tmp_path / "mid.npz"),
                                "--save-prefix", str(tmp_path / "c" / "m")]), output=resumed)
    whole_rows = _rows(whole.getvalue())[1]
    resumed_rows = _rows(resumed.getvalue())[1]
    assert [r[1] for r in whole_rows] == ["1", "2", "3", "4", "5", "6", "7", "8"]
    assert resumed_rows == whole_rows[3:]
    a = tfactory.load_picker(str(tmp_path / "a" / "m_epoch2.npz"), device="cpu")
    c = tfactory.load_picker(str(tmp_path / "c" / "m_epoch2.npz"), device="cpu")
    for (name, x), y in zip(a.state_dict().items(), c.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)
    # batchnorm's running statistics moved from their start (0, 1)
    assert float(a.layers[0].bn_var.sub(1).abs().max()) > 1e-3


def test_train_cli_runs_in_a_subprocess(tmp_path):
    argv = _dataset(tmp_path, n_images=2) + [
        "-n", "10", "--num-epochs", "1", "--epoch-size", "2", "--no-pretrained",
        "--units", "4", "--bn", "off", "-d", "cpu", "--save-prefix", str(tmp_path / "m"),
        "-o", str(tmp_path / "log.tsv")]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "topaz_tpu_torch", "train"] + argv,
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    header, rows = _rows((tmp_path / "log.tsv").read_text())
    assert header == ["epoch", "iter", "split", "loss", "ge_penalty", "precision",
                      "adjusted_precision", "tpr", "fpr", "auprc"]
    assert [r[:3] for r in rows] == [["1", "1", "train"], ["1", "2", "train"]]
    assert all(np.isfinite(float(v)) for r in rows for v in r[3:-1])
    assert "# Done!" in out.stderr
    spec, _, _ = jfactory.load_picker(str(tmp_path / "m_epoch1.npz"))
    assert (spec.arch, spec.width) == ("resnet8", 71)


@pytest.mark.parametrize("flags,item", [
    (["-d", "-2"], "no CUDA device is available"),
])
def test_unported_paths_exit_naming_their_item(tmp_path, flags, item, monkeypatch):
    """``train -d -2`` with no GPU exits with the no-device error and
    trains nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "model.sav").write_bytes(b"")
    argv = _dataset(tmp_path, n_images=1) + ["-n", "5", "--num-epochs", "1", "--epoch-size", "1",
                                             "--no-pretrained", "--units", "4",
                                             "--save-prefix", str(tmp_path / "m")]
    with pytest.raises(SystemExit) as e:
        tmain(["train"] + argv + [f.format(d=tmp_path) for f in flags])
    assert item in str(e.value.code) and "-d -2" in str(e.value.code)
    assert not list(tmp_path.glob("m_epoch*"))
