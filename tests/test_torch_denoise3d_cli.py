"""Denoiser training and tomogram denoising through the port's CLI against
the JAX package's command on the same files, on the CPU: ``denoise -a/-b``
then 2D inference with the trained model, and ``denoise3d -a/-b`` then
``denoise3d -m <checkpoint>``. The JAX commands run in this process at
``-d 0``, one device (the tests' JAX has eight virtual ones).

Tolerances, as in ``test_torch_denoise_train.py`` and
``test_torch_denoise3d.py``: rows rtol 1e-4; checkpoint parameters atol
1e-4 x their tensor's largest magnitude (adagrad, the default); output
MRCs 1e-4 x the input's std (XLA's float32 CPU reductions of the patch
statistics drift from the port's pairwise sums).
"""

import os

import numpy as np
import pytest

from topaz_tpu.cli.commands import denoise as jdenoise_cmd
from topaz_tpu.cli.commands import denoise3d as jdenoise3d_cmd
from topaz_tpu.models import denoise_factory as jfactory
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import denoise_factory as tfactory
from torch_threads import one_torch_thread  # noqa: F401


def _run_jax(cmd, argv):
    cmd.main(cmd.add_arguments().parse_args(argv))


def _rows(text):
    rows = [line.split("\t") for line in text.replace("\r", "\n").split("\n")
            if line.startswith("# [")]
    return np.array([[float(v) for v in r[1:]] for r in rows])


def _same_checkpoint(got_path, want_path):
    gmeta, got = jfactory.load_denoiser(got_path)
    wmeta, want = jfactory.load_denoiser(want_path)
    assert gmeta == wmeta
    for mod, convs in want.items():
        for idx, p in convs.items():
            for k in ("w", "b"):
                np.testing.assert_allclose(got[mod][idx][k], p[k], rtol=0,
                                           atol=1e-4 * np.abs(p[k]).max())


def _both(capsys, tmp_path, jcmd, port_argv, jax_argv):
    """Run the JAX command and the port's CLI; their stdout rows."""
    rows = {}
    for tag, run in (("jax", lambda: _run_jax(jcmd, jax_argv("jax") + ["-d", "0"])),
                     ("port", lambda: tmain(port_argv("port") + ["-d", "cpu"]))):
        capsys.readouterr()
        run()
        rows[tag] = _rows(capsys.readouterr().out)
    return rows


def test_denoise_train_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for d in ("A", "B"):
        (tmp_path / d).mkdir()
    for i in range(5):
        clean = np.cumsum(np.cumsum(rng.normal(size=(56, 64)), 0), 1) / 20
        for d in ("A", "B"):
            mrc.write(str(tmp_path / d / f"m{i}.mrc"),
                      (clean + rng.normal(size=clean.shape)).astype(np.float32))
    mic = str(tmp_path / "A" / "m0.mrc")

    def argv(tag):
        return ["-a", str(tmp_path / "A"), "-b", str(tmp_path / "B"), "--arch", "unet-small",
                "-c", "32", "--batch-size", "2", "--num-epochs", "2", "--holdout", "0.2",
                "--save-prefix", str(tmp_path / tag / "P"), "-s", "0",
                "-o", str(tmp_path / tag / "out"), mic]

    rows = _both(capsys, tmp_path, jdenoise_cmd, lambda t: ["denoise"] + argv(t), argv)
    assert rows["port"].shape == rows["jax"].shape == (2, 3)
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    _same_checkpoint(str(tmp_path / "port" / "P_epoch1.npz"),
                     str(tmp_path / "jax" / "P_epoch1.npz"))
    # the bundled unet-small (nf 48) was the starting point
    assert tfactory.load_denoiser(str(tmp_path / "port" / "P_epoch1.npz"),
                                  device="cpu").meta["nf"] == 48
    got = mrc.read(str(tmp_path / "port" / "out" / "m0.mrc"))[0]
    want = mrc.read(str(tmp_path / "jax" / "out" / "m0.mrc"))[0]
    x = mrc.read(mic)[0]
    assert got.shape == x.shape and not np.allclose(got, x)
    np.testing.assert_allclose(got, want, atol=1e-4 * x.std(), rtol=0)


def test_denoise3d_cli_matches_jax(tmp_path, capsys):
    """Training fine-tunes a small 3D checkpoint given with -m (the JAX
    command loads -m before it falls back to a fresh full-width unet);
    then inference with the epoch checkpoint, resident patches and -g."""
    rng = np.random.default_rng(1)
    clean = rng.normal(size=(28, 30, 26)).cumsum(0).cumsum(1) / 20
    even = (clean + rng.normal(size=clean.shape)).astype(np.float32)
    odd = (clean + rng.normal(size=clean.shape)).astype(np.float32)
    mrc.write(str(tmp_path / "even.mrc"), even)
    mrc.write(str(tmp_path / "odd.mrc"), odd)
    start = str(tmp_path / "start.npz")
    model = tfactory.new_denoiser("unet-small", nf=4, base_width=5, dims=3, seed=3)
    tfactory.save_denoiser(start, model.meta, model)

    def train(tag):
        return ["-a", str(tmp_path / "even.mrc"), "-b", str(tmp_path / "odd.mrc"), "-m", start,
                "-c", "12", "--N-train", "6", "--N-test", "3", "--batch-size", "3",
                "--num-epochs", "2", "--save-interval", "1",
                "--save-prefix", str(tmp_path / tag / "P3")]

    rows = _both(capsys, tmp_path, jdenoise3d_cmd, lambda t: ["denoise3d"] + train(t), train)
    assert rows["port"].shape == rows["jax"].shape == (2, 3)
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in ("P3_epoch1.npz", "P3_epoch2.npz"):
        _same_checkpoint(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))

    def infer(tag):
        return ["-m", str(tmp_path / "jax" / "P3_epoch2.npz"), "-s", "8", "-p", "4", "-g", "0.8",
                "-o", str(tmp_path / tag / "out"), str(tmp_path / "even.mrc")]

    _both(capsys, tmp_path, jdenoise3d_cmd, lambda t: ["denoise3d"] + infer(t), infer)
    got = mrc.read(str(tmp_path / "port" / "out" / "even.mrc"))[0]
    want = mrc.read(str(tmp_path / "jax" / "out" / "even.mrc"))[0]
    assert got.shape == even.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * even.std(), rtol=0)


@pytest.mark.parametrize("argv,message", [
    (["denoise3d", "-d", "cpu", "{d}/tomo.mrc"], "3D pretrained weights are not bundled"),
    (["denoise3d", "-d", "cpu", "-m", "unet-3d-20a", "{d}/tomo.mrc"], "not bundled"),
    (["denoise3d", "-d", "cpu", "-a", "{d}/tomo.mrc", "{d}/tomo.mrc"], "needs both"),
    (["denoise", "-d", "cpu", "-b", "{d}", "{d}/tomo.mrc"], "needs both"),
])
def test_cli_refusals(tmp_path, capsys, argv, message):
    mrc.write(str(tmp_path / "tomo.mrc"), np.zeros((8, 8, 8), np.float32))
    with pytest.raises(SystemExit) as e:
        tmain([a.format(d=tmp_path) for a in argv])
    assert e.value.code != 0
    assert message in str(e.value.code) + capsys.readouterr().err
