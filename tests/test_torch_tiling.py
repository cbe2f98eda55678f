"""Tiled dense scoring (``predict_in_patches``) against whole-image scoring
and the JAX package's, on the CPU.

The dense picker is shift-equivariant, so uniform tiles with the
receptive-field halo give whole-image scores: the port's tiled map equals
its whole-image map and JAX's tiled map within atol 1e-4, rtol 1e-4
(float32 convolutions sum in another order per tile shape and in XLA),
including a ragged last batch and an image that is no multiple of the
tile. ``extract -p`` writes the same picks as the JAX CLI and as the
port's whole-image scoring."""

import numpy as np
import pytest
import torch

from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu.models import factory as jfactory
from topaz_tpu.models import tiling as jtiling
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models import factory as tfactory
from topaz_tpu_torch.models import tiling as ttiling
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,patch,batch", [
    ((90, 101), 32, 4),     # 3 x 4 tiles: batches of 4, 4, 4
    ((90, 101), 32, 5),     # the last batch ragged (2 of 5)
    ((40, 30), 64, 4),      # one tile, batch capped at 1
])
def test_predict_in_patches_equals_whole_and_jax(shape, patch, batch):
    spec, params, state = jfactory.load_picker("resnet8_u32")
    model = tfactory.load_picker("resnet8_u32", device="cpu")
    x = np.random.default_rng(patch + batch).normal(size=shape).astype(np.float32)
    got = ttiling.predict_in_patches(model, x, patch, batch_size=batch)
    assert got.shape == shape and got.device.type == "cpu"
    with torch.inference_mode():
        whole = model(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got.numpy(), whole, **TOL)
    want = jtiling.predict_in_patches(spec, params, state, x, patch, batch_size=batch)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _table(path):
    with open(path) as f:
        next(f)
        rows = [line.rstrip("\n").split("\t") for line in f]
    return [r[:3] for r in rows], np.array([float(r[3]) for r in rows])


def test_extract_patch_size_matches_the_jax_cli_and_whole_scoring(tmp_path):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(120, 136)).astype(np.float32)
    yy, xx = np.mgrid[:120, :136]
    for cy, cx in ((30, 40), (80, 100), (60, 20), (100, 70)):
        x -= 3 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0).astype(np.float32)
    path = str(tmp_path / "mic.mrc")
    mrc.write(path, x)
    argv = ["extract", "-m", "resnet8_u32", "-r", "6", "-t", "-3", path]
    args = j_build_parser().parse_args(argv + ["-p", "48", "-o", str(tmp_path / "jax.txt")])
    args.func(args)
    tmain(argv + ["-p", "48", "-d", "cpu", "-o", str(tmp_path / "port.txt")])
    tmain(argv + ["-d", "cpu", "-o", str(tmp_path / "whole.txt")])
    jrows, jscores = _table(tmp_path / "jax.txt")
    trows, tscores = _table(tmp_path / "port.txt")
    wrows, wscores = _table(tmp_path / "whole.txt")
    assert len(trows) >= 4
    assert trows == jrows == wrows
    np.testing.assert_allclose(tscores, jscores, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tscores, wscores, atol=1e-4, rtol=0)
