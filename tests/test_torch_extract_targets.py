"""Validation against labeled targets and the radius search, against the
JAX package on the CPU.

``match_coordinates`` must equal JAX's exactly (the same scipy Hungarian
assignment on the same costs). ``extract_auprc`` and ``find_opt_radius`` on
the same seeded score maps and targets give the same AUPRC (within 1e-6),
RMSE, recall and target count, the same radius, and the same printed lines.
Through the CLI (``-m none``: the maps are the inputs), ``--targets``
without ``-r`` prints the JAX functions' lines and extracts at their
radius, with ``-r`` prints one validation line, and ``--only-validate``
stops after it.

The JAX CLI keys its score maps by path and its targets by image name, so
no target matches there (``targets=0``, AUPRC nan); the port keys both by
image name, and its CLI lines equal the JAX functions' on name-keyed maps."""

import os

import numpy as np
import pandas as pd
import pytest

from topaz_tpu import extract as jextract
from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu.ops.metrics import match_coordinates as j_match
from topaz_tpu_torch import extract as textract
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.coordinates import Coordinates
from topaz_tpu_torch.ops.metrics import match_coordinates as t_match
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n_pred,n_target,dtype", [(40, 12, np.float64), (9, 30, np.float32),
                                                   (0, 5, np.float64), (6, 0, np.float32)])
def test_match_coordinates_equals_jax(n_pred, n_target, dtype):
    rng = np.random.default_rng(n_pred + n_target)
    preds = rng.integers(0, 60, (n_pred, 2)).astype(dtype)
    targets = (rng.integers(0, 60, (n_target, 2)) + rng.normal(size=(n_target, 2))).astype(dtype)
    for radius in (3, 7.5):
        got, want = t_match(targets, preds, radius), j_match(targets, preds, radius)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _maps_and_targets(dims=2, n_images=3, seed=0):
    """Score maps with a peak near each of 6 targets an image, one decoy
    and noise; the targets as a DataFrame and as the port's table."""
    rng = np.random.default_rng(seed)
    shape = (56, 60) if dims == 2 else (14, 18, 20)
    scores, rows = {}, []
    for i in range(n_images):
        name = f"mic{i}"
        x = rng.normal(-4, 1, size=shape).astype(np.float32)
        for _ in range(6):
            c = [int(rng.integers(3, n - 3)) for n in shape]
            rows.append([name] + c[::-1])
            jitter = [min(n - 1, max(0, ci + int(rng.integers(-1, 2)))) for ci, n in zip(c, shape)]
            x[tuple(jitter)] = rng.uniform(1, 5)
        x[tuple(int(rng.integers(0, n)) for n in shape)] = 3.0
        scores[name] = x
    cols = ["image_name", "x_coord", "y_coord"] + (["z_coord"] if dims == 3 else [])
    frame = pd.DataFrame(rows, columns=cols)
    table = Coordinates.from_columns({c: frame[c].to_numpy() for c in cols})
    return scores, frame, table


@pytest.mark.parametrize("dims,radius,match_radius", [(2, 3, None), (2, 6, 4), (3, 2, None)])
def test_extract_auprc_matches_jax(dims, radius, match_radius):
    scores, frame, table = _maps_and_targets(dims)
    want = jextract.extract_auprc(frame, scores, radius, -2.0, match_radius=match_radius,
                                  dims=dims)
    got = textract.extract_auprc(table, scores, radius, -2.0, match_radius=match_radius,
                                 dims=dims, device="cpu")
    assert want[3] == 18 and want[2] > 0
    assert got[2:] == want[2:]
    assert abs(got[0] - want[0]) <= 1e-6
    assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_find_opt_radius_matches_jax(capsys):
    scores, frame, table = _maps_and_targets(seed=1)
    want = jextract.find_opt_radius(frame, scores, -2.0, lo=1, hi=11, step=5)
    want_lines = capsys.readouterr().out
    got = textract.find_opt_radius(table, scores, -2.0, lo=1, hi=11, step=5, device="cpu")
    got_lines = capsys.readouterr().out
    assert got[0] == want[0] and abs(got[1] - want[1]) <= 1e-6
    assert got_lines == want_lines and got_lines.count("# radius=") == 3


def _write_inputs(tmp_path):
    scores, frame, _ = _maps_and_targets(seed=2)
    paths = []
    for name, x in scores.items():
        paths.append(str(tmp_path / f"{name}.mrc"))
        mrc.write(paths[-1], x)
    targets = str(tmp_path / "targets.txt")
    frame.to_csv(targets, sep="\t", index=False)
    return scores, frame, paths, targets


def _jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    args.func(args)


def _lines(text):
    return [line for line in text.splitlines() if line.startswith("# radius=")]


def test_cli_targets_search_validate_and_only_validate(tmp_path, capsys):
    scores, frame, paths, targets = _write_inputs(tmp_path)
    base = ["extract", "-m", "none", "-t", "-2", "--targets", targets]

    # radius search: the JAX functions' lines on name-keyed maps, then picks
    # at the radius found, as the JAX CLI extracts them at that radius
    grid = ["--min-radius", "1", "--max-radius", "11", "--step-radius", "5"]
    radius, _ = jextract.find_opt_radius(frame, scores, -2.0, lo=1, hi=11, step=5)
    want = _lines(capsys.readouterr().out)
    tmain(base + grid + ["-d", "cpu", "-o", str(tmp_path / "port.txt")] + paths)
    assert _lines(capsys.readouterr().out) == want and len(want) == 3
    _jax_cli(["extract", "-m", "none", "-t", "-2", "-r", str(radius),
              "-o", str(tmp_path / "jax.txt")] + paths)
    with open(tmp_path / "port.txt") as f, open(tmp_path / "jax.txt") as g:
        assert f.read() == g.read()

    # -r: one validation line, equal to the JAX function's
    au, rmse, recall, n = jextract.extract_auprc(frame, scores, 6, -2.0)
    tmain(base + ["-r", "6", "-d", "cpu", "-o", str(tmp_path / "r6.txt")] + paths)
    assert _lines(capsys.readouterr().out) == [
        f"# radius=6, auprc={au}, rmse={rmse}, recall={recall}, targets={n}"]
    assert os.path.exists(tmp_path / "r6.txt")

    # --only-validate: the line, and no picks written
    tmain(base + ["-r", "6", "--only-validate", "-d", "cpu",
                  "-o", str(tmp_path / "none.txt")] + paths)
    assert _lines(capsys.readouterr().out) == [
        f"# radius=6, auprc={au}, rmse={rmse}, recall={recall}, targets={n}"]
    assert not os.path.exists(tmp_path / "none.txt")

    # the JAX CLI matches no target (maps keyed by path)
    _jax_cli(base + ["-r", "6", "--only-validate"] + paths)
    assert _lines(capsys.readouterr().out)[0].endswith("targets=0")


def test_cli_default_grid_runs_every_radius(tmp_path, capsys):
    scores, frame, paths, targets = _write_inputs(tmp_path)
    tmain(["extract", "-m", "none", "-t", "-2", "--targets", targets, "--only-validate",
           "-d", "cpu"] + paths)
    lines = _lines(capsys.readouterr().out)
    assert [int(line.split(",")[0].split("=")[1]) for line in lines] == list(range(5, 101, 5))
    assert all(line.endswith("targets=18") for line in lines)


def test_cli_without_radius_or_targets_raises(tmp_path):
    with pytest.raises(ValueError, match="Must specify targets"):
        tmain(["extract", "-m", "none", "-d", "cpu", str(tmp_path / "x.mrc")])
