"""The batched CLI paths of the port against the JAX package's CLI.

``normalize -s 2 --batch-size 2 --metadata`` and
``extract -m resnet8_u32 -r 6 -t 1 --batch-size 2`` run once through
``python -m topaz_tpu`` (JAX on the CPU) and once through the port's CLI
with ``-d cpu``, on three micrographs of three shapes made with numpy from a
seed. Normalized MRCs agree to 1e-4 and the metadata to rtol 1e-5 (float32
FFT and EM sums run in other orders); the pick tables are identical apart
from the scores, which agree to 1e-4. The paths not yet ported exit with an
error that says so."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from topaz_tpu_torch.cli.main import main
from topaz_tpu_torch.io import mrc
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(128, 128), (136, 120), (96, 96)]


def _jax_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               TOPAZ_NO_COMPILE_CACHE="1")
    out = subprocess.run([sys.executable, "-m", "topaz_tpu"] + args, capture_output=True,
                         text=True, cwd=cwd, env=env, timeout=600)
    assert out.returncode == 0, f"topaz_tpu {args}:\n{out.stdout}\n{out.stderr}"


@pytest.fixture(scope="module")
def micrographs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mics")
    rng = np.random.default_rng(11)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        x = rng.normal(0, 1, (h, w)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for cy, cx in ((h // 3, w // 3), (2 * h // 3, 2 * w // 3), (h // 4, 3 * w // 4)):
            x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0).astype(np.float32)
        paths.append(str(d / f"m{i}.mrc"))
        mrc.write(paths[-1], x)
    return paths


def test_batched_normalize_matches_the_jax_cli(micrographs, tmp_path):
    args = ["normalize", "-s", "2", "--batch-size", "2", "--metadata"]
    _jax_cli(args + ["-o", str(tmp_path / "jax")] + micrographs, tmp_path)
    main(args + ["-d", "cpu", "-o", str(tmp_path / "port")] + micrographs)
    for path, (h, w) in zip(micrographs, SHAPES):
        name = os.path.splitext(os.path.basename(path))[0]
        want = mrc.read(str(tmp_path / "jax" / f"{name}.mrc"))[0]
        got = mrc.read(str(tmp_path / "port" / f"{name}.mrc"))[0]
        assert got.shape == want.shape == (h // 2, w // 2)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        with open(tmp_path / "jax" / f"{name}.metadata.json") as f:
            jmd = json.load(f)
        with open(tmp_path / "port" / f"{name}.metadata.json") as f:
            tmd = json.load(f)
        assert tmd.keys() == jmd.keys()
        for k in ("mu", "std", "pi", "logp"):
            np.testing.assert_allclose(tmd[k], jmd[k], rtol=1e-5, err_msg=k)
        assert (tmd["alpha"], tmd["beta"], tmd["sample"], tmd["bins"]) == \
            (jmd["alpha"], jmd["beta"], jmd["sample"], jmd["bins"])


@pytest.mark.parametrize("kw", [dict(affine=True), dict(bins=4096)])
def test_batched_normalize_variants_match_jax(micrographs, tmp_path, kw):
    """The affine and histogram fits of ``normalize_images_batched``, with a
    dead frame in the batch: normalized images within 1e-4, metadata within
    rtol 1e-5, and the dead frame zeroed with a warning, as JAX does it."""
    import warnings

    from topaz_tpu.preprocess import normalize_images_batched as jax_batched
    from topaz_tpu_torch.preprocess import normalize_images_batched

    dead = str(tmp_path / "dead.mrc")
    mrc.write(dead, np.full((96, 96), 2.5, np.float32))
    paths = micrographs + [dead]
    jax_batched(paths, str(tmp_path / "jax"), scale=2, metadata=True, batch_size=2, **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        normalize_images_batched(paths, str(tmp_path / "port"), scale=2, metadata=True,
                                 batch_size=2, device="cpu", **kw)
    assert any("constant image" in str(w.message) and "dead.mrc" in str(w.message)
               for w in rec)
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        want = mrc.read(str(tmp_path / "jax" / f"{name}.mrc"))[0]
        got = mrc.read(str(tmp_path / "port" / f"{name}.mrc"))[0]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)
        with open(tmp_path / "jax" / f"{name}.metadata.json") as f:
            jmd = json.load(f)
        with open(tmp_path / "port" / f"{name}.metadata.json") as f:
            tmd = json.load(f)
        assert tmd.keys() == jmd.keys()
        for k in ("mu", "std", "pi"):
            np.testing.assert_allclose(tmd[k], jmd[k], rtol=1e-5, err_msg=f"{name} {k}")
    assert not mrc.read(str(tmp_path / "port" / "dead.mrc"))[0].any()


def _table(path):
    with open(path) as f:
        header = next(f)
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert header == "image_name\tx_coord\ty_coord\tscore\n"
    return [r[:3] for r in rows], np.array([float(r[3]) for r in rows])


def test_batched_extract_matches_the_jax_cli(micrographs, tmp_path):
    args = ["extract", "-m", "resnet8_u32", "-r", "6", "-t", "1", "--batch-size", "2"]
    _jax_cli(args + ["-o", str(tmp_path / "jax.txt")] + micrographs, tmp_path)
    main(args + ["-d", "cpu", "-o", str(tmp_path / "port.txt")] + micrographs)
    want_rows, want_scores = _table(tmp_path / "jax.txt")
    got_rows, got_scores = _table(tmp_path / "port.txt")
    assert len(got_rows) >= 3 * len(SHAPES)
    assert got_rows == want_rows
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-4, rtol=0)


@pytest.mark.parametrize("argv", [
    ["normalize", "-d", "-2", "--batch-size", "2"],
    ["extract", "-m", "resnet8_u32", "-r", "6", "-d", "-2", "--batch-size", "2"],
    ["extract", "-m", "resnet8_u32", "-r", "6", "-d", "-2", "--batch-size", "2",
     "--per-micrograph"],
])
def test_not_ported_batched_paths_exit_with_an_error(micrographs, tmp_path, argv,
                                                    monkeypatch):
    """``-d -2`` with no GPU exits with the no-device error and writes
    nothing: it never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(argv + ["-o", str(tmp_path / "out")] + micrographs)
    assert "no CUDA device is available" in str(e.value.code)
    assert not (tmp_path / "out").exists()
