"""``train --resume`` from a training state that the JAX package wrote.

The JAX package trains epoch 1 of a 2D run and saves its whole state; the
port resumes from it and trains epoch 2. Dropout is 0 and 2D crops are
augmented by the host sampler, whose stream carries over exactly, so the
JAX step key that cannot cross goes unused, and the port's epoch-2 rows
agree with JAX's uninterrupted two-epoch run to rtol 1e-3, atol 1e-5 (the
tolerance of ``test_torch_train_run.py``). With ``--autoencoder`` the
decoder's weights and Adam moments cross too: the run-level parity of the
generator, whose fresh weights the port cannot draw as JAX draws them."""

import io
import shutil

import numpy as np
import pytest

from topaz_tpu.cli.commands import train as jcli
from topaz_tpu.train import trainer as jtrainer
from topaz_tpu.training import train_from_args as j_train_from_args
from topaz_tpu_torch.cli.commands import train as tcli
from topaz_tpu_torch.training import train_model as t_train_model
from test_torch_train_run import _assert_rows_close, _dataset, _rows
from torch_threads import one_torch_thread  # noqa: F401


def _jax_run_keeping_epoch1_state(tmp_path, monkeypatch, argv):
    """JAX's uninterrupted two-epoch log, and its state after epoch 1."""
    save = jtrainer.save_train_state

    def save_and_keep(path, state, epoch, it, steps_in_epoch, **kw):
        save(path, state, epoch, it, steps_in_epoch, **kw)
        if (epoch, steps_in_epoch) == (1, 0):
            shutil.copy(path, tmp_path / "jax_epoch1_state.npz")

    monkeypatch.setattr(jtrainer, "save_train_state", save_and_keep)
    j_train_from_args(jcli.add_arguments().parse_args(
        argv + ["--num-epochs", "2", "--save-prefix", str(tmp_path / "jax" / "m"),
                "-o", str(tmp_path / "jax.tsv")]))
    monkeypatch.undo()
    return (tmp_path / "jax.tsv").read_text(), str(tmp_path / "jax_epoch1_state.npz")


@pytest.mark.parametrize("flags", [
    ["--test-images", "{d}/mics", "--test-targets", "{d}/t.txt"],
    ["--autoencoder", "1", "--ngf", "8"],
    ["--no-pretrained", "--units", "4", "--bn", "on"],
], ids=["pretrained", "autoencoder", "bn"])
def test_resume_from_a_jax_state_continues_its_run(tmp_path, monkeypatch, capsys, flags):
    argv = _dataset(tmp_path) + [f.format(d=tmp_path) for f in flags] + [
        "-n", "15", "--epoch-size", "3", "--dropout", "0"]
    want, state_path = _jax_run_keeping_epoch1_state(tmp_path, monkeypatch, argv)
    capsys.readouterr()

    out = io.StringIO()
    t_train_model(tcli.add_arguments().parse_args(
        argv + ["--num-epochs", "2", "--resume", state_path, "-d", "cpu",
                "--save-prefix", str(tmp_path / "port" / "m")]), output=out)
    err = capsys.readouterr().err
    assert "# Resuming at epoch 2 (iter 4)" in err
    assert "step key does not carry over" in err
    header, want_rows = _rows(want)
    epoch2 = "\n".join(["\t".join(header)] + ["\t".join(r) for r in want_rows if r[0] == "2"])
    _assert_rows_close(out.getvalue(), epoch2)
    if "--autoencoder" in flags:
        assert "recon_error" in header
        # the port's epoch checkpoint carries the decoder as the JAX package's does
        with np.load(tmp_path / "port" / "m_epoch2.npz") as got, \
                np.load(tmp_path / "jax" / "m_epoch2.npz") as jax_ckpt:
            keys = sorted(k for k in jax_ckpt.files if k.startswith("params:generative"))
            assert keys and keys == sorted(k for k in got.files
                                           if k.startswith("params:generative"))
            for k in keys:
                np.testing.assert_allclose(got[k], jax_ckpt[k], rtol=0, atol=1e-4, err_msg=k)


def test_resume_from_a_jax_state_of_another_arch_fails_on_shape(tmp_path, monkeypatch):
    argv = _dataset(tmp_path, n_images=2) + ["-n", "10", "--epoch-size", "1", "--no-pretrained",
                                             "--bn", "off"]
    _, state_path = _jax_run_keeping_epoch1_state(tmp_path, monkeypatch, argv + ["--units", "4"])
    with pytest.raises(ValueError, match=r"leaf \d+ has shape .* \(architecture mismatch\)"):
        t_train_model(tcli.add_arguments().parse_args(
            argv + ["--units", "8", "--num-epochs", "2", "--resume", state_path, "-d", "cpu"]),
            output=io.StringIO())
    with pytest.raises(ValueError, match="leaves but the current"):
        t_train_model(tcli.add_arguments().parse_args(
            argv + ["--units", "4", "--bn", "on", "--num-epochs", "2", "--resume", state_path,
                    "-d", "cpu"]), output=io.StringIO())
