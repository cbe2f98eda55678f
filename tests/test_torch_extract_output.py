"""``extract --per-micrograph`` output and the ``downsample`` command,
against the JAX package's CLI on the CPU.

Single-image route: ``-m none`` (the seeded score maps are the inputs, so
both packages hold the same scores) in the coord, star, box, json and csv
formats, with ``--suffix``, into a directory and, for an ``-o`` that is a
file path, into ``COORDS/`` beside it: every file byte-equal to the JAX
CLI's. Batched route (``--batch-size 2``, a model): every file byte-equal
to what the JAX package's ``write_table`` writes for the same picks, and
the box files (no scores) byte-equal to the JAX CLI's. ``downsample``'s
output agrees with the JAX command's within 1e-5."""

import os

import numpy as np
import pandas as pd
import pytest

from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu.io import coordinates as jcoords
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from torch_threads import one_torch_thread  # noqa: F401

FORMATS = ["coord", "star", "box", "json", "csv"]


def _jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    args.func(args)


def _read_all(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module")
def score_maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    rng = np.random.default_rng(21)
    paths = []
    for i, shape in enumerate([(60, 70), (48, 52)]):
        x = (np.round(rng.normal(size=shape) * 8) / 8).astype(np.float32)
        paths.append(str(d / f"map{i}.mrc"))
        mrc.write(paths[-1], x)
    return paths


@pytest.mark.parametrize("fmt", FORMATS)
def test_per_micrograph_single_route_bytes_equal(score_maps, tmp_path, fmt):
    for tag in ("jax", "port"):
        os.makedirs(tmp_path / tag)
        argv = ["extract", "-m", "none", "-r", "4", "-t", "0.5", "--per-micrograph",
                "--suffix", "_picks", "--format", fmt, "-o", str(tmp_path / tag)] + score_maps
        _jax_cli(argv) if tag == "jax" else tmain(argv + ["-d", "cpu"])
    want, got = _read_all(tmp_path / "jax"), _read_all(tmp_path / "port")
    assert sorted(got) == [f"map0_picks.{fmt}", f"map1_picks.{fmt}"]
    assert got == want
    assert all(len(text) > 40 for text in got.values())


def test_per_micrograph_file_output_goes_to_coords(score_maps, tmp_path):
    """An ``-o`` that is no directory: the files go to COORDS/ beside it;
    ``-x 2`` scales the coordinates."""
    for tag in ("jax", "port"):
        argv = ["extract", "-m", "none", "-r", "4", "-t", "0.5", "-x", "2",
                "--per-micrograph", "--format", "star",
                "-o", str(tmp_path / tag / "sub" / "picks.txt")] + score_maps
        _jax_cli(argv) if tag == "jax" else tmain(argv + ["-d", "cpu"])
    want = _read_all(tmp_path / "jax" / "sub" / "COORDS")
    assert _read_all(tmp_path / "port" / "sub" / "COORDS") == want
    assert sorted(want) == ["map0.star", "map1.star"]


@pytest.fixture(scope="module")
def micrographs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mics")
    rng = np.random.default_rng(22)
    paths = []
    for i, (h, w) in enumerate([(96, 96), (104, 88), (96, 96)]):
        x = rng.normal(0, 1, (h, w)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for cy, cx in ((h // 3, w // 3), (2 * h // 3, 2 * w // 3), (h // 4, 3 * w // 4)):
            x -= 3.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0).astype(np.float32)
        paths.append(str(d / f"m{i}.mrc"))
        mrc.write(paths[-1], x)
    return paths


def test_per_micrograph_batched_route(micrographs, tmp_path):
    argv = ["extract", "-m", "resnet8_u32", "-r", "6", "-t", "1", "-d", "cpu"]
    tmain(argv + ["--batch-size", "2", "-o", str(tmp_path / "table.txt")] + micrographs)
    table = pd.read_csv(tmp_path / "table.txt", sep="\t", dtype={"image_name": str})
    table["score"] = table["score"].astype(np.float32)
    assert len(table) >= 3 * len(micrographs)
    for fmt in FORMATS:
        out = tmp_path / fmt
        os.makedirs(out)
        tmain(argv + ["--batch-size", "2", "--per-micrograph", "--format", fmt,
                      "-o", str(out)] + micrographs)
        got = _read_all(out)
        assert sorted(got) == [f"m{i}.{fmt}" for i in range(len(micrographs))]
        for name, text in got.items():
            stem = name.split(".")[0]
            picks = table.loc[table.image_name == stem].reset_index(drop=True)
            want = tmp_path / f"want_{name}"
            with open(want, "w") as f:
                jcoords.write_table(f, picks, format=fmt, image_ext=".mrc")
            assert text == want.read_text(), (fmt, name)
    # box files carry no score: byte-equal to the JAX CLI's
    os.makedirs(tmp_path / "jax_box")
    _jax_cli(argv[:-2] + ["--per-micrograph", "--format", "box",
                          "-o", str(tmp_path / "jax_box")] + micrographs)
    assert _read_all(tmp_path / "box") == _read_all(tmp_path / "jax_box")


def test_downsample_matches_the_jax_command(tmp_path):
    x = np.random.default_rng(23).normal(size=(96, 120)).astype(np.float32)
    src = str(tmp_path / "raw.mrc")
    mrc.write(src, x)
    _jax_cli(["downsample", "-s", "3", "-o", str(tmp_path / "jax.mrc"), src])
    tmain(["downsample", "-s", "3", "-d", "cpu", "-o", str(tmp_path / "port.mrc"), src])
    want, jheader, _ = mrc.read(str(tmp_path / "jax.mrc"))
    got, theader, _ = mrc.read(str(tmp_path / "port.mrc"))
    assert got.shape == want.shape == (32, 40)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert theader == jheader
