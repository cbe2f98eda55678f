"""The 11 coordinate commands of the port against the JAX package's CLI, on
the CPU.

Each case runs the same argv in both packages, each in its own copy of the
same input files (coordinate tables, STAR files with extra columns and the
legacy score column, EMAN .box files, a VIA CSV, MRC micrographs, all made
from seeded numpy draws): the standard output and every file the command
writes must be byte-equal. The exceptions are the particle stacks resized
on the device (``particle_stack --resize``): their STAR file and MRC header
are byte-equal, and the pixels agree within 1e-4 (float32: two FFT
libraries and two sum orders over standardized crops) or within one count
(int16: the write truncates the standardized values, so a value within
rounding of an integer may land on either side).

Image names stay strings in the port. The JAX package reads some tables
without a dtype, so names such as ``0001`` become the number 1 there:
``split`` fails, ``scale_coordinates`` writes ``1``, ``particle_stack``
looks for ``1.mrc``; the port keeps ``0001`` (the last test).
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from topaz_tpu.cli.main import build_parser as j_build_parser
from topaz_tpu_torch.cli.main import main as tmain
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.io.table import parse_float
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ["mic_b", "mic_a", "mic_c"]
SHAPES = {"mic_a": (90, 110), "mic_b": (70, 96), "mic_c": (80, 80)}


def _jax_cli(argv):
    args = j_build_parser().parse_args(argv)
    args.func(args)


def _write_inputs(d, rng):
    """Coordinate files of every input format and the micrographs they
    point at."""
    os.makedirs(d / "images")
    for name, shape in SHAPES.items():
        mrc.write(str(d / "images" / f"{name}.mrc"), rng.normal(size=shape).astype(np.float32))
    rows = []
    for i in range(18):
        name = NAMES[i % 3]
        h, w = SHAPES[name]
        # float32 shortest strings and float64 17-digit strings, which
        # pandas' reader and Python's float() read differently
        score = str(np.float32(rng.normal())) if i % 2 else repr(float(rng.normal()))
        rows.append(f"{name}\t{rng.integers(0, w)}\t{rng.integers(0, h)}\t{score}")
    (d / "picks.txt").write_text("image_name\tx_coord\ty_coord\tscore\n" + "\n".join(rows) + "\n")
    (d / "noscore.txt").write_text(
        "image_name\tx_coord\ty_coord\n"
        + "".join(f"mic_d\t{rng.integers(0, 60)}\t{rng.integers(0, 60)}\n" for _ in range(4)))
    # diameters and coordinates whose scaled values are halves (round half
    # to even) and a ceiling
    (d / "diam.txt").write_text(
        "image_name\tx_coord\ty_coord\tdiameter\tscore\n"
        + "".join(f"mic_a\t{x}\t{y}\t{dm}\t0.5\n"
                  for x, y, dm in [(2, 6, 9), (10, 14, 10), (6, 3, 11), (101, 50, 7)]))
    star_rows = []
    for i in range(9):
        star_rows.append(f"{i + 1}@stack.mrcs\tmic_{'ab'[i % 2]}.mrc\t{rng.integers(0, 90)}.0"
                         f"\t{rng.integers(0, 70)}.0\t{rng.normal():.6f}\t{20000 + i}.5\t300")
    (d / "extra.star").write_text(
        "\ndata_\n\nloop_\n_rlnImageName #1\n_rlnMicrographName #2\n_rlnCoordinateX #3\n"
        "_rlnCoordinateY #4\n_rlnAutopickFigureOfMerit #5\n_rlnDefocusU #6\n_rlnVoltage #7\n"
        + "\n".join(star_rows) + "\n")
    (d / "legacy.star").write_text(
        "data_images\nloop_\n_rlnMicrographName\n_rlnCoordinateX\n_rlnCoordinateY\n"
        "_rlnParticleScore\n"
        + "".join(f"MotionCorr/job002/mic_c.mrc\t{rng.integers(0, 80)}\t{rng.integers(0, 80)}"
                  f"\t{rng.normal():.4f}\n" for _ in range(5)))
    for name in ("mic_a", "mic_b"):
        (d / f"{name}.box").write_text("".join(
            f"{rng.integers(0, 60)}\t{rng.integers(0, 40)}\t32\t32\n" for _ in range(4)))
    (d / "empty.box").write_text("")
    (d / "via.csv").write_text(
        "filename,file_size,file_attributes,region_count,region_id,region_shape_attributes,"
        "region_attributes\n"
        + "".join(f'mic_a.png,-1,{{}},3,{i},"{{""name"":""point"",""cx"":{10 + i},'
                  f'""cy"":{20 + 3 * i}}}","{{""score"":""{0.25 * i}""}}"\n' for i in range(3)))
    (d / "meta.star").write_text(
        "data_\nloop_\n_rlnMicrographName #1\n_rlnDetectorPixelSize #2\n_rlnVoltage #3\n"
        "mic_a.mrc\t5.0\t300\nmic_b.mrc\t5.0\t200\nmic_b.mrc\t2.5\t300\n")
    os.makedirs(d / "out")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("inputs")
    _write_inputs(d, np.random.default_rng(5))
    return d


def _tree(d):
    """{file: bytes} under ``d``, with ``d`` itself written as ``<dir>``
    (the image lists hold absolute paths)."""
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read().replace(str(d).encode(), b"<dir>")
    return out


def _run_both(inputs, tmp_path, monkeypatch, argv, port_flags=()):
    """{package: (stdout, {file: bytes})} of ``argv`` run in a copy of the
    inputs."""
    out = {}
    for tag, run in (("jax", _jax_cli), ("port", tmain)):
        d = tmp_path / tag
        shutil.copytree(inputs, d)
        monkeypatch.chdir(d)
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            run(list(argv) + (list(port_flags) if tag == "port" else []))
        out[tag] = (stdout.getvalue(), _tree(d))
    return out


CASES = {
    "convert_to_star_scaled": ["convert", "picks.txt", "--to", "star", "--voltage", "300",
                               "--detector-pixel-size", "1.5", "-x", "4"],
    "convert_mixed_score": ["convert", "picks.txt", "noscore.txt", "--to", "coord"],
    "convert_mixed_score_star": ["convert", "noscore.txt", "picks.txt", "--to", "star",
                                 "-o", "out/all.star"],
    "convert_star_fast_path": ["convert", "extra.star", "legacy.star", "-o", "out/x.star",
                               "-s", "2", "-t", "0", "--magnification", "60000"],
    "convert_star_to_coord": ["convert", "extra.star", "legacy.star", "--to", "coord",
                              "--amplitude-contrast", "0.1"],
    "convert_invert_y_ext": ["convert", "picks.txt", "--invert-y", "--imagedir", "images",
                             "--image-ext", "mrc", "--to", "coord", "-t", "-0.5"],
    "convert_invert_y_dotted": ["convert", "picks.txt", "--invert-y", "--imagedir", "images",
                                "--to", "star", "-o", "out/inv.star"],
    "convert_invert_y_any": ["convert", "picks.txt", "--invert-y", "--imagedir", "images",
                             "--image-ext", "*", "--to", "csv"],
    "convert_to_box_dir": ["convert", "picks.txt", "-o", "out/", "--boxsize", "32",
                           "--suffix", "_p"],
    "convert_to_json_dir": ["convert", "picks.txt", "extra.star", "-o", "out/", "-x", "2"],
    "convert_boxes": ["convert", "mic_a.box", "mic_b.box", "empty.box", "--to", "coord"],
    "convert_via_csv": ["convert", "via.csv", "--to", "star", "--voltage", "200"],
    "convert_auto_csv": ["convert", "picks.txt", "-o", "out/picks.csv", "-s", "3"],
    "boxes_to_coordinates": ["boxes_to_coordinates", "mic_a.box", "mic_b.box", "empty.box"],
    "boxes_to_coordinates_invert": ["boxes_to_coordinates", "mic_a.box", "mic_b.box",
                                    "--invert-y", "--imagedir", "images", "--image-ext", "mrc",
                                    "-o", "out/back.txt"],
    "coordinates_to_boxes": ["coordinates_to_boxes", "picks.txt", "picks.txt",
                             "--destdir", "out/boxes", "--boxsize", "40"],
    "coordinates_to_boxes_invert": ["coordinates_to_boxes", "picks.txt", "--destdir",
                                    "out/boxes", "--boxsize", "24", "--invert-y",
                                    "--imagedir", "images", "--image-ext", "mrc"],
    "coordinates_to_eman2_json": ["coordinates_to_eman2_json", "picks.txt", "noscore.txt",
                                  "--destdir", "out/json"],
    "coordinates_to_eman2_json_invert": ["coordinates_to_eman2_json", "picks.txt",
                                         "--destdir", "out/json", "--invert-y", "--imagedir",
                                         "images", "--image-ext", "mrc"],
    "coordinates_to_star": ["coordinates_to_star", "picks.txt", "--voltage", "300",
                            "--defocus-u", "15000", "--spherical-aberation", "2.7",
                            "--amplitude-contrast", "0"],
    "coordinates_to_star_noscore": ["coordinates_to_star", "noscore.txt", "--image-ext",
                                    ".tiff"],
    "star_to_coordinates": ["star_to_coordinates", "extra.star"],
    "star_to_coordinates_legacy": ["star_to_coordinates", "legacy.star", "-o", "out/c.txt"],
    "scale_coordinates": ["scale_coordinates", "diam.txt"],
    "scale_coordinates_up": ["scale_coordinates", "picks.txt", "-s", "2.5", "-o", "out/s.txt"],
    "star_particles_threshold": ["star_particles_threshold", "extra.star", "-t", "0.1"],
    "star_particles_threshold_legacy": ["star_particles_threshold", "legacy.star",
                                        "-o", "out/t.star"],
    "split_coord": ["split", "picks.txt", "-o", "out", "-t", "0", "--suffix", "_s"],
    "split_star": ["split", "extra.star", "-o", "out/", "--format", "star"],
    "split_star_paths": ["split", "legacy.star", "-o", "out", "-t", "-0.5"],
    "train_test_split": ["train_test_split", "picks.txt", "--image-dir", "images", "-n", "1",
                         "--seed", "3"],
    "train_test_split_star": ["train_test_split", "extra.star", "--image-dir", "images",
                              "-n", "1", "--image-ext", "mrc"],
    "particle_stack": ["particle_stack", "picks.txt", "-o", "out/stack.mrcs", "--image-root",
                       "images", "--size", "24", "--metadata", "meta.star"],
    "particle_stack_threshold": ["particle_stack", "picks.txt", "-o", "out/stack.mrcs",
                                 "--image-root", "images", "--size", "31",
                                 "--threshold", "0.2"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_command_output_is_byte_equal(inputs, tmp_path, monkeypatch, case):
    out = _run_both(inputs, tmp_path, monkeypatch, CASES[case], port_flags=(
        ["-d", "cpu"] if CASES[case][0] == "particle_stack" else []))
    (jax_stdout, jax_files), (port_stdout, port_files) = out["jax"], out["port"]
    assert port_stdout == jax_stdout
    assert sorted(port_files) == sorted(jax_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    new = {k for k in jax_files if k not in _tree(inputs)} | ({"stdout"} if jax_stdout else set())
    assert new, "the command wrote nothing"


def test_mixed_score_inputs_drop_rows_without_a_score(inputs, tmp_path, monkeypatch):
    """pandas' NaN fill: the table without a score column contributes NaN
    scores, which fail even the default -inf threshold."""
    out = _run_both(inputs, tmp_path, monkeypatch, CASES["convert_mixed_score"])
    text = out["port"][0]
    assert "mic_d" not in text and text.count("\n") == 19


def test_train_test_split_draws_as_numpy(inputs, tmp_path, monkeypatch):
    out = _run_both(inputs, tmp_path, monkeypatch, CASES["train_test_split"])
    files = out["port"][1]
    test_list = files["image_list_test.txt"].decode().splitlines()
    order = np.random.RandomState(3).permutation(3)
    assert test_list[1].split("\t")[0] == sorted(NAMES)[order[0]]
    assert files["picks_train.txt"] == out["jax"][1]["picks_train.txt"]


def _stack_case(inputs, tmp_path, monkeypatch, dtype, resize):
    d = tmp_path / "in"
    shutil.copytree(inputs, d)
    rng = np.random.default_rng(11)
    for name, shape in SHAPES.items():
        x = (rng.normal(size=(1,) + shape) * 30).astype(dtype)
        with open(d / "images" / f"{name}.mrc", "wb") as f:
            f.write(mrc.default_header(x.shape, dtype=dtype).tobytes() + x.tobytes())
    argv = ["particle_stack", "picks.txt", "-o", "out/stack.mrcs", "--image-root", "images",
            "--size", "32", "--resize", str(resize), "--metadata", "meta.star"]
    out = _run_both(d, tmp_path, monkeypatch, argv, port_flags=["-d", "cpu"])
    return out["jax"][1], out["port"][1]


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4), (np.int16, 1)])
def test_particle_stack_resize_within_tolerance(inputs, tmp_path, monkeypatch, dtype, tol):
    want, got = _stack_case(inputs, tmp_path, monkeypatch, dtype, resize=12)
    assert got["out/stack.star"] == want["out/stack.star"]
    assert b"\t13.333333333333332\t" in got["out/stack.star"]  # 5.0 x (32 / 12)
    a, b = got["out/stack.mrcs"], want["out/stack.mrcs"]
    assert len(a) == len(b) and a[:1024] == b[:1024]
    x = np.frombuffer(a[1024:], dtype=dtype).astype(np.float64)
    y = np.frombuffer(b[1024:], dtype=dtype).astype(np.float64)
    assert x.size == 18 * 12 * 12
    assert np.abs(x - y).max() <= tol
    if dtype == np.float32:
        crops = x.reshape(18, 144)
        np.testing.assert_allclose(crops.std(axis=1), 1, atol=1e-4)


def test_particle_stack_int16_without_resize_is_byte_equal(inputs, tmp_path, monkeypatch):
    want, got = _stack_case(inputs, tmp_path, monkeypatch, np.int16, resize=-1)
    assert got == want
    counts = np.frombuffer(got["out/stack.mrcs"][1024:], dtype=np.int16)
    assert counts.size == 18 * 32 * 32 and 0 < np.abs(counts).max() <= 5


def test_pandas_float_parser():
    """``read_csv``'s numbers are pandas' (17-digit accumulation then a
    power-of-ten scale), not Python's correctly rounded ``float``."""
    import pandas as pd

    rng = np.random.default_rng(2)
    texts = [repr(float(v)) for v in rng.normal(size=2000) * 10.0 ** rng.integers(-8, 8, 2000)]
    texts += [f"{v:.20f}" for v in rng.normal(size=200)] + ["1e5", "-0.0", ".5", "7."]
    want = pd.read_csv(io.StringIO("s\n" + "\n".join(texts) + "\n"))["s"].to_numpy()
    got = np.array([parse_float(t) for t in texts])
    assert np.array_equal(got, want)
    assert sum(float(t) != w for t, w in zip(texts, want)) > 100


def test_numeric_image_names_stay_strings(tmp_path, monkeypatch):
    """JAX's untyped reads turn ``0001`` into 1: its ``split`` raises, its
    ``scale_coordinates`` writes ``1``, its ``particle_stack`` looks for
    ``1.mrc``. The port keeps ``0001`` (ROADMAP queue 3)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "n.txt").write_text("image_name\tx_coord\ty_coord\tscore\n"
                                    "0001\t10\t12\t0.5\n0002\t20\t8\t1.5\n0001\t30\t30\t-1\n")
    os.makedirs("j")
    os.makedirs("p")
    with pytest.raises(TypeError, match="unsupported operand"):
        _jax_cli(["split", "n.txt", "-o", "j"])
    tmain(["split", "n.txt", "-o", "p"])
    assert sorted(os.listdir("p")) == ["0001.txt", "0002.txt"]
    assert (tmp_path / "p" / "0001.txt").read_text().splitlines()[1:] == [
        "0001\t10\t12\t0.5", "0001\t30\t30\t-1.0"]

    _jax_cli(["scale_coordinates", "n.txt", "-s", "2", "-o", "j.txt"])
    tmain(["scale_coordinates", "n.txt", "-s", "2", "-o", "p.txt"])
    assert (tmp_path / "j.txt").read_text().splitlines()[1].startswith("1\t20\t24")
    assert (tmp_path / "p.txt").read_text().splitlines()[1] == "0001\t20\t24\t0.5"

    os.makedirs("images")
    for name in ("0001", "0002"):
        mrc.write(f"images/{name}.mrc", np.random.default_rng(0).normal(
            size=(48, 48)).astype(np.float32))
    with pytest.raises(FileNotFoundError, match="1.mrc"):
        _jax_cli(["particle_stack", "n.txt", "-o", "j.mrcs", "--image-root", "images",
                  "--size", "16"])
    tmain(["particle_stack", "n.txt", "-o", "p.mrcs", "--image-root", "images", "--size", "16",
           "-d", "cpu"])
    assert "0001.mrc" in (tmp_path / "p.star").read_text()
    assert mrc.read("p.mrcs")[0].shape == (3, 16, 16)


@pytest.mark.parametrize("with_source,dims", [(False, 2), (True, 2), (False, 3)])
def test_coordinates_dict_and_matching_equal_jax(with_source, dims):
    """``coordinates_table_to_dict`` and ``match_coordinates_to_images``
    (coordinates, and masks of radius 3) against the JAX package's on the
    same table; an image without coordinates gets none."""
    import pandas as pd

    from topaz_tpu.ops import masks as jmasks
    from topaz_tpu_torch.io.coordinates import Coordinates
    from topaz_tpu_torch.io.table import Table
    from topaz_tpu_torch.ops import masks as tmasks

    rng = np.random.default_rng(dims + 2 * with_source)
    shape = (12, 30, 40)[3 - dims:]
    columns = {"image_name": [f"m{i % 3}" for i in range(15)],
               "x_coord": rng.integers(0, 40, 15), "y_coord": rng.integers(0, 30, 15)}
    if dims == 3:
        columns["z_coord"] = rng.integers(0, 12, 15)
    if with_source:
        columns["source"] = [f"s{i % 2}" for i in range(15)]
    frame = pd.DataFrame(columns)
    table = Table({k: np.array(v, dtype=object) if k in ("image_name", "source") else v
                   for k, v in columns.items()})
    want, got = jmasks.coordinates_table_to_dict(frame), tmasks.coordinates_table_to_dict(table)

    def flat(d):
        return {(k,) + kk: vv for k, v in d.items()
                for kk, vv in (flat(v).items() if isinstance(v, dict) else [((), v)])}

    assert sorted(flat(got)) == sorted(flat(want))
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v)
    from_coords = flat(tmasks.coordinates_table_to_dict(Coordinates.from_columns(table.data)))
    assert all(np.array_equal(from_coords[k], v) for k, v in flat(got).items())
    images = {f"m{i}": rng.normal(size=shape).astype(np.float32) for i in range(4)}
    if with_source:
        images = {"s0": images, "s1": {"m1": images["m1"]}}
    for radius in (-1, 3):
        want = flat(jmasks.match_coordinates_to_images(frame, images, radius=radius))
        got = flat(tmasks.match_coordinates_to_images(table, images, radius=radius))
        assert sorted(got) == sorted(want)
        for k, (im, target) in want.items():
            assert got[k][0] is im
            np.testing.assert_array_equal(got[k][1], target)


NEW_COMMANDS = ["convert", "boxes_to_coordinates", "coordinates_to_boxes",
                "coordinates_to_eman2_json", "coordinates_to_star", "star_to_coordinates",
                "scale_coordinates", "star_particles_threshold", "split", "train_test_split",
                "particle_stack", "segment", "gui", "serve", "watch", "warmup"]


@pytest.mark.parametrize("command", NEW_COMMANDS)
def test_flags_and_defaults_are_the_jax_clis(command):
    """Every flag of the JAX command, with its default, choices, nargs and
    whether it is required; the port adds only ``-d`` to ``particle_stack``
    and takes ``-d cpu`` in ``segment``, ``serve``, ``watch`` and ``warmup``
    (default 0 in all)."""
    import argparse
    import importlib

    def actions(package):
        parser = argparse.ArgumentParser()
        importlib.import_module(f"{package}.cli.commands.{command}").add_arguments(parser)
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.required)
                for a in parser._actions if a.dest != "help"}

    want, got = actions("topaz_tpu"), actions("topaz_tpu_torch")
    if command == "particle_stack":
        assert got.pop("device") == (("-d", "--device"), 0, None, None, False)
    assert got == want
    from topaz_tpu_torch.cli.main import NOT_PORTED, build_parser

    assert NOT_PORTED == ()
    argv = {"gui": [], "coordinates_to_boxes": ["x", "--destdir", "d", "--boxsize", "8"],
            "coordinates_to_eman2_json": ["x", "--destdir", "d"], "serve": [], "warmup": [],
            "watch": ["x", "-o", "p.txt"]}.get(command, ["x"])
    assert build_parser().parse_args([command] + argv).command == command
