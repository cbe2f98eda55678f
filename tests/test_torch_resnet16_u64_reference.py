"""Topaz's default picker ``resnet16_u64`` (ResNet16, units 64) with weights
written the way the benchmark's ``extract2d`` driver writes them (seeded,
HWIO ``.npz``): the benchmark's plain reference
(``benchmark/reference/model.picker_scores``) against the JAX package's
picker, and the port's per-micrograph ``extract_particles`` against the
reference's maps, on the CPU.

Tolerances, each with its reason:

* Reference against JAX: 1e-4 x max(1, |score|) at each pixel. Both run
  float32 convolutions over the same weights, XLA and PyTorch summing each
  output's up to 128 x 25 products in their own order, through 16 layers
  whose residual sums grow the map to ~10x the input's size. Measured at
  this seed: each side 1.8e-5 from the same network in float64, the two
  2.4e-5 apart.
* Picks: ``check.pick_gap`` at the cell's limit, the comparison that decides
  the cell's ``correct`` on the card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from topaz_tpu.models import factory as jfactory
from topaz_tpu.models.picker import apply_picker
from topaz_tpu_torch import extract
from topaz_tpu_torch.models.factory import load_picker
from torch_threads import one_torch_thread  # noqa: F401

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.append(BENCH_DIR)

from harness import check, inputs, spec  # noqa: E402
from reference import counts, model  # noqa: E402

TOL = 1e-4
CELL = spec.Cell(spec.load(), "extract.k3_s4")
DRIVER = spec.driver("extract2d")


def _model(units):
    return dict(CELL.config["picker_seeded"], units=units, layers=DRIVER.layers(units))


def _weights(tmp_path, units, seed=26):
    path = str(tmp_path / f"resnet16_u{units}_{seed}.npz")
    DRIVER.write_weights(path, _model(units), seed)
    return path


def _gap(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1)).max())


def test_reference_matches_jax_picker_at_units_64(tmp_path):
    path = _weights(tmp_path, 64)
    layers = DRIVER.layers(64)
    assert layers == CELL.config["picker_seeded"]["layers"]
    assert model.receptive_field(layers) == 91
    assert counts.picker_flops_per_pixel(layers) == 3_652_224
    spec_, params, state = jfactory.load_picker(path)
    assert (spec_.arch, spec_.width) == ("resnet16", 91)
    x = np.random.default_rng(3).normal(size=(1, 64, 96)).astype(np.float32)
    want, _ = apply_picker(spec_, params, jnp.asarray(x), state=state, dense=True)
    want = torch.from_numpy(np.array(want))
    with torch.no_grad():
        got = model.picker_scores(torch.from_numpy(x), layers, model.load_npz(path, "cpu"))
    assert got.shape == want.shape == x.shape
    assert float(want.std()) > 0.1  # a map with structure, not a constant
    assert _gap(got, want) <= TOL


def test_weight_writer_follows_the_seed_and_loads_in_the_port(tmp_path):
    a, b, c = (str(tmp_path / f"{k}.npz") for k in "abc")
    for p, seed in zip((a, b, c), (5, 5, 6)):
        DRIVER.write_weights(p, _model(64), seed)
    za, zb, zc = (np.load(p) for p in (a, b, c))
    assert za.files == zb.files
    assert all(np.array_equal(za[k], zb[k]) for k in za.files)
    assert not np.array_equal(za["params:features.0.conv_w"], zc["params:features.0.conv_w"])
    assert za["params:features.5.proj_w"].shape == (1, 1, 64, 128)
    assert "params:features.5.proj_b" not in za.files
    assert za["params:classifier.w"].shape == (1, 1, 256, 1)
    picker = load_picker(a, device="cpu")
    assert (picker.spec.arch, picker.spec.width, picker.spec.latent_dim) == ("resnet16", 91, 256)
    assert sum(p.numel() for p in picker.parameters()) == 1_827_649
    torch.testing.assert_close(picker.layers[5].proj_w,
                               torch.from_numpy(za["params:features.5.proj_w"]).permute(3, 2, 0, 1),
                               rtol=0, atol=0)


def test_extract_particles_picks_against_reference(tmp_path):
    """Three micrographs through ``extract_particles`` at batch size 1, the
    cell's route, judged against the reference's maps as the cell's
    ``check`` judges them: at the threshold the reference's map of the
    first gives by the cell's rule."""
    units, r, rank = 8, 4, 12
    path = _weights(tmp_path, units)
    rng = np.random.default_rng(9)
    files = []
    for i, shape in enumerate([(40, 56), (48, 40), (36, 60)]):
        f = str(tmp_path / f"mic_{i}.mrc")
        inputs.write_mrc(f, rng.normal(size=shape).astype(np.float32))
        files.append(f)
    maps = DRIVER.ReferenceMaps({"picker_seeded": _model(units)}, path, "cpu", False)
    S = [maps(f) for f in files]
    t = DRIVER.reference_threshold(S[0], r, rank)
    out = str(tmp_path / "picks.txt")
    before = extract.micrographs_picked
    extract.extract_particles(files, model=path, threshold=t, radius=r, batch_size=1,
                              output=out, device="cpu")
    assert extract.micrographs_picked == before + 3
    names = [f"mic_{i}" for i in range(3)]
    answers = DRIVER.read_answers([out], names)
    limit = CELL.config["limits"]["pick_gap"]
    for name, s in zip(names, S):
        (answer,) = answers[name]
        scores, coords = DRIVER.parse_answer(answer)
        assert check.pick_gap(s, scores, coords, r, t) <= limit
    assert len(DRIVER.parse_answer(next(iter(answers["mic_0"])))[0]) == rank - 1
    # a wrong answer reads over the limit: a pick left out
    scores, coords = DRIVER.parse_answer(next(iter(answers["mic_0"])))
    assert check.pick_gap(S[0], scores[1:], coords[1:], r, t) > limit
