"""``segment`` in the port against the JAX package's CLI, on the CPU.

2D: ``resnet8_u32`` over two micrographs, whole and with ``-p 20`` (tiles
of 40, the reference's 2x rule), the ``.tiff`` maps read back with PIL;
3D: a conv31 picker (units 4) saved by the port over a 20 x 24 x 28 volume,
whole and with ``-p 6`` (tiles of 12), ``.npy`` maps. Maps agree with the
JAX package's ``segment_images`` within atol 1e-4, rtol 1e-4 (float32
convolutions in two libraries, ``tests/test_torch_picker.py``'s tolerance)
and have the input's shape; a tiled map equals the port's whole map within
the same tolerance. ``-d -2`` without a GPU exits with the no-device error; the default
``resnet16`` alias (u64 weights) is not in the repo in either package.
"""

import os

import numpy as np
import pytest
import torch

from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import factory as tfactory
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    args.func(args)


def _read_tiff(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def _segment_both(tmp_path, paths, model, patch, reader, ext):
    maps = {}
    for tag in ("jax", "port"):
        out = tmp_path / f"{tag}_{patch}"
        argv = ["segment", "-m", model, "-o", str(out)] + (["-p", str(patch)] if patch else [])
        _jax_cli(argv + paths) if tag == "jax" else tmain(argv + ["-d", "cpu"] + paths)
        maps[tag] = {name: reader(str(out / name)) for name in sorted(os.listdir(out))}
    assert sorted(maps["port"]) == sorted(maps["jax"])
    assert all(name.endswith(ext) for name in maps["port"])
    for name, want in maps["jax"].items():
        got = maps["port"][name]
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    return maps["port"]


def test_segment_2d_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    paths = []
    for i, shape in enumerate([(60, 70), (48, 64)]):
        paths.append(str(tmp_path / f"mic{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=shape).astype(np.float32))
    whole = _segment_both(tmp_path, paths, "resnet8_u32", None, _read_tiff, ".tiff")
    tiled = _segment_both(tmp_path, paths, "resnet8_u32", 20, _read_tiff, ".tiff")
    assert whole["mic0.tiff"].shape == (60, 70) and whole["mic1.tiff"].shape == (48, 64)
    for name in whole:
        np.testing.assert_allclose(tiled[name], whole[name], **TOL)


def test_segment_3d_matches_jax(tmp_path):
    vol = np.random.default_rng(9).normal(size=(20, 24, 28)).astype(np.float32)
    path = str(tmp_path / "tomo.mrc")
    mrc.write(path, vol)
    ckpt = str(tmp_path / "picker3d.npz")
    tfactory.save_picker(ckpt, tfactory.new_picker("conv31", units=4, dims=3, seed=2,
                                                   device="cpu"))
    whole = _segment_both(tmp_path, [path], ckpt, None, np.load, ".npy")
    tiled = _segment_both(tmp_path, [path], ckpt, 6, np.load, ".npy")
    assert whole["tomo.npy"].shape == vol.shape
    np.testing.assert_allclose(tiled["tomo.npy"], whole["tomo.npy"], **TOL)


def test_segment_refuses_what_is_not_there(tmp_path, monkeypatch):
    path = str(tmp_path / "mic.mrc")
    mrc.write(path, np.zeros((16, 16), np.float32))
    with monkeypatch.context() as m:  # -d -2 with no GPU: the no-device error, no CPU run
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            tmain(["segment", "-m", "resnet8_u32", "-o", str(tmp_path), "-d", "-2", path])
    assert "no CUDA device is available" in str(e.value.code)
    assert not (tmp_path / "mic.tiff").exists()
    with pytest.raises(FileNotFoundError, match="not bundled"):
        tmain(["segment", "-o", str(tmp_path), "-d", "cpu", path])
    with pytest.raises(ValueError, match="patch size must be positive"):
        tmain(["segment", "-p", "0", "-o", str(tmp_path), "-d", "cpu", path])
