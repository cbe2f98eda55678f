"""The port's 3D picker (ResNet8, ``dims=3``) and its tomogram picks against
the benchmark's plain reference (``benchmark/reference/picker3d.py``:
``torch.nn.functional`` from the published ``ResNet8`` and greedy sphere
NMS), on the CPU, with weights written the way the benchmark's
``extract3d`` driver writes them (seeded, DHWIO ``.npz``). No JAX.

Tolerances, each with its reason:

* Dense scores, the port's whole-volume forward against the reference's
  z-slabs and the port's tiles against its whole-volume forward: 1e-5 x
  max(1, |score|) at each voxel. Both sides run the same float32
  convolutions, on inputs blocked differently (a whole padded volume, a
  slab with its halo, 166^3-style windows), so the convolution routines may
  sum each output's up to 64 x 125 products in another order: ~1e-7 of the
  score a term. Measured: 0 (bit-equal) in these cases on one thread, up to
  2.4e-7 x max(1, |score|) with several threads splitting the sums.
* Picks: ``pick_gap_3d`` <= 1e-5, the same rounding seen through greedy
  NMS's conditions (at most twice the map's error).
* Operation counts and the CLI's output against ``pick_volume``'s: equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from topaz_tpu_torch import extract
from topaz_tpu_torch.cli.main import main as cli
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models.factory import load_picker
from topaz_tpu_torch.models.tiling import classify_patches_3d
from topaz_tpu_torch.ops.nms import non_maximum_suppression_3d
from torch_threads import one_torch_thread  # noqa: F401

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from harness import spec  # noqa: E402
from reference import picker3d  # noqa: E402

TOL = 1e-5


def _model(units, bn=True):
    return {"arch": "resnet8", "units": units, "dims": 3, "bn": bn,
            "layers": picker3d.layers(units)}


def _weights(tmp_path, units, seed=24, bn=True):
    path = str(tmp_path / f"picker3d_u{units}_bn{int(bn)}.npz")
    spec.driver("extract3d").write_weights(path, _model(units, bn), seed)
    return path


def _volume(shape, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def _gap(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1)).max())


@pytest.mark.parametrize("units, shape, slab, bn", [
    (8, (20, 24, 28), 5, True), (32, (8, 10, 12), 4, True), (8, (12, 14, 16), 5, False)])
def test_picker3d_forward_matches_reference(tmp_path, units, shape, slab, bn):
    path = _weights(tmp_path, units, bn=bn)
    picker = load_picker(path, device="cpu")
    assert picker.spec.dims == 3 and picker.spec.width == 71
    # batch norm on (the configuration's, topaz train's default): no
    # convolution bias, a norm after each convolution
    assert hasattr(picker.layers[0], "bn_scale") is bn
    assert hasattr(picker.layers[0], "conv_b") is not bn
    x = torch.from_numpy(_volume(shape))
    with torch.inference_mode():
        got = picker(x[None])[0]
    want = picker3d.picker3d_scores(x, picker3d.layers(units), picker3d.load_npz(path, "cpu"),
                                    slab=slab)
    assert got.shape == want.shape == x.shape
    assert float(want.std()) > 0.1  # a map with structure, not a constant
    assert _gap(got, want) <= TOL


@pytest.mark.parametrize("patch_size, batch_size", [(16, 1), (8, 5)])
def test_tiled_scores_match_whole_volume(tmp_path, patch_size, batch_size):
    picker = load_picker(_weights(tmp_path, 8), device="cpu")
    vol = _volume((10, 12, 18), seed=4)
    with torch.inference_mode():
        whole = picker(torch.from_numpy(vol)[None])[0]
    tiled = classify_patches_3d(picker, vol, patch_size, batch_size)
    assert tiled.shape == whole.shape
    assert _gap(tiled, whole) <= TOL


@pytest.mark.parametrize("units, radius, shape, patch_size", [
    (8, 3, (16, 20, 24), 16), (8, 5, (16, 20, 24), 16), (32, 2, (10, 12, 12), 16)])
def test_pick_volume_picks_against_reference(tmp_path, units, radius, shape, patch_size):
    path = _weights(tmp_path, units)
    picker = load_picker(path, device="cpu")
    vol = _volume(shape, seed=5)
    S = picker3d.picker3d_scores(torch.from_numpy(vol), picker3d.layers(units),
                                 picker3d.load_npz(path, "cpu"), slab=16)
    t = float(torch.quantile(S.reshape(-1), 0.95))
    scores, coords = extract.pick_volume(picker, vol, radius, t, patch_size=patch_size,
                                         batch_size=2)
    assert len(scores) >= 2 and coords.shape == (len(scores), 3)
    assert (np.diff(scores) <= 0).all()  # descending
    assert picker3d.pick_gap_3d(S, scores, coords, radius, t) <= TOL
    # the reference's own greedy picks read no gap, and a wrong answer does
    taken = picker3d.greedy_nms_3d(S, radius, t)
    zs, ys, xs = torch.nonzero(taken, as_tuple=True)
    ref_coords = torch.stack([xs, ys, zs], 1).numpy()
    assert picker3d.pick_gap_3d(S, S[zs, ys, xs].numpy(), ref_coords, radius, t) == 0.0
    assert sorted(map(tuple, ref_coords)) == sorted(map(tuple, coords))
    assert picker3d.pick_gap_3d(S, scores[1:], coords[1:], radius, t) > 1e-3
    assert picker3d.pick_gap_3d(S, scores, coords, radius + 4, t) == picker3d.FAULT


def test_extract_dims3_writes_pick_volume_picks(tmp_path):
    """``extract --dims 3`` goes through ``pick_volume`` (its counter
    moves), and its table is the one the earlier route wrote: 96^3 tiles
    at batch 1, then ``non_maximum_suppression_3d``."""
    path = _weights(tmp_path, 2)  # one window of 166^3: the narrowest picker
    vol = _volume((14, 20, 22), seed=6)
    tomo = str(tmp_path / "tomo_a.mrc")
    mrc.write(tomo, vol)
    vol = mrc.read(tomo)[0]
    picker = load_picker(path, device="cpu")
    score = classify_patches_3d(picker, vol)
    t = float(torch.quantile(score.reshape(-1), 0.9))
    want_s, want_c = non_maximum_suppression_3d(score, 3, threshold=t, device="cpu")
    s, c = extract.pick_volume(picker, vol, 3, t)
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(c, want_c)
    out = str(tmp_path / "picks.txt")
    before = extract.volumes_picked
    cli(["extract", "--dims", "3", "-m", path, "-r", "3", "-t", repr(t), "-o", out, "-d", "cpu",
         tomo])
    assert extract.volumes_picked == before + 1
    lines = ["image_name\tx_coord\ty_coord\tz_coord\tscore"] + [
        f"tomo_a\t{x}\t{y}\t{z}\t{v}" for (x, y, z), v in zip(want_c, want_s)]
    with open(out) as f:
        assert f.read() == "\n".join(lines) + "\n"
    assert len(lines) > 3


def test_picker3d_operation_count():
    """The count from the layer list: 2,793,152 operations a voxel at units
    32, and equal to the multiply-adds of every convolution the reference
    runs for one map voxel (shapes only, on the meta device; batch norm's
    affine step is not counted)."""
    layers = picker3d.layers(32)
    assert picker3d.picker3d_flops_per_voxel(layers) == 2_793_152
    cfg = spec.Cell(spec.load(), "extract3d.tomo").config["picker3d"]
    assert cfg["layers"] == layers
    ops = []
    real = picker3d.F.conv3d

    def counting(x, w, b=None, **kw):
        ops.append(2 * w.numel())  # cout cin k^3 multiply-adds an output voxel
        return real(x, w, b, **kw)

    w = {}
    for i, layer in enumerate(layers):
        p = f"features.{i}."
        names = ([("conv", layer["cin"], layer["cout"], layer["k"])] if layer["op"] == "conv"
                 else [("conv0", layer["cin"], layer["hidden"], 3),
                       ("conv1", layer["hidden"], layer["cout"], 3)])
        for name, cin, cout, k in names:
            w[p + name + "_w"] = torch.empty((cout, cin, k, k, k), device="meta")
            bn = p + name.replace("conv", "bn")
            for key in ("scale", "bias", "mean", "var"):
                w[f"{bn}.{key}"] = torch.empty((cout,), device="meta")
        if layer["op"] == "resid" and layer["cin"] != layer["cout"]:
            w[p + "proj_w"] = torch.empty((layer["cout"], layer["cin"], 1, 1, 1), device="meta")
    w["classifier.w"] = torch.empty((1, 128, 1, 1, 1), device="meta")
    w["classifier.b"] = torch.empty((1,), device="meta")
    mp = pytest.MonkeyPatch()
    mp.setattr(picker3d.F, "conv3d", counting)
    try:
        out = picker3d.picker3d_scores(torch.empty((1, 1, 1), device="meta"), layers, w, slab=1)
    finally:
        mp.undo()
    assert out.shape == (1, 1, 1) and len(ops) == 10
    assert sum(ops) == 2_793_152
