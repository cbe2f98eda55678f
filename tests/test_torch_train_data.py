"""The port's training data path against the JAX package's: coordinate
files, the crop sampler, k-fold partitions, masks, metrics, pi and the
on-device augmentation.

Everything here is host numpy and is held exact: the same seed and the same
files give bit-equal crops and labels (native C gather and numpy path), the
same folds and the same rows. The rotation of ``augment_crops`` is held
exact too, angles given to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from topaz_tpu.io import coordinates as jcoords
from topaz_tpu.io import mrc as jmrc
from topaz_tpu.ops import masks as jmasks
from topaz_tpu.ops import metrics as jmetrics
from topaz_tpu.preprocess import calculate_pi as j_calculate_pi
from topaz_tpu.preprocess import pixels_given_radius as j_pixels_given_radius
from topaz_tpu.train import augment as jaugment
from topaz_tpu.train import data as jdata
from topaz_tpu.train import partition as jpartition
from topaz_tpu_torch.io import coordinates as tcoords
from topaz_tpu_torch.ops import masks as tmasks
from topaz_tpu_torch.ops import metrics as tmetrics
from topaz_tpu_torch.preprocess import calculate_pi, pixels_given_radius
from topaz_tpu_torch.train import augment as taugment
from topaz_tpu_torch.train import data as tdata
from topaz_tpu_torch.train import partition as tpartition
from torch_threads import one_torch_thread  # noqa: F401


def _micrographs(tmp_path, shapes, n_particles=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rows = []
    for i, (h, w) in enumerate(shapes):
        x = rng.normal(0, 1, (h, w)).astype(dtype)
        jmrc.write(str(tmp_path / f"img{i}.mrc"), x)
        for _ in range(n_particles):
            rows.append((f"img{i}", int(rng.integers(0, w)), int(rng.integers(0, h))))
    path = tmp_path / "targets.txt"
    path.write_text("image_name\tx_coord\ty_coord\n"
                    + "".join(f"{n}\t{x}\t{y}\n" for n, x, y in rows))
    return [str(tmp_path / f"img{i}.mrc") for i in range(len(shapes))], str(path)


def _assert_table_equal(got: tcoords.Coordinates, want: pd.DataFrame):
    assert len(got) == len(want)
    for col in ("image_name", "x_coord", "y_coord", "score", "source"):
        if col not in want.columns:
            assert getattr(got, col, None) is None, col
            continue
        w = want[col].to_numpy()
        g = getattr(got, col)
        if col == "image_name":
            assert g.tolist() == [str(v) for v in w]
        else:
            np.testing.assert_array_equal(g.astype(np.float64), w.astype(np.float64))


@pytest.mark.parametrize("split", ["pn", "pu"])
@pytest.mark.parametrize("native", [True, False])
def test_crop_sampler_bit_equal_to_jax(tmp_path, split, native):
    # a particle at the border, one outside the image and one in a
    # micrograph the images lack: out-of-bounds pixels and missing names
    paths, targets = _micrographs(tmp_path, [(90, 100), (120, 80), (100, 100)])
    with open(targets, "a") as f:
        f.write("img0\t0\t1\nimg1\t500\t3\nimg9\t5\t5\n")
    want_sampler = jdata.CropSampler(paths, jcoords.read_coordinates(targets), 71,
                                     radius=3, split=split, seed=7)
    got_sampler = tdata.CropSampler(paths, tcoords.read_coordinates(targets), 71,
                                    radius=3, split=split, seed=7, native=native)
    assert got_sampler.num_pixels == want_sampler.num_pixels
    assert got_sampler.mask_size == want_sampler.mask_size == 29
    for n_pos in (0, 3, 16, 5):
        got = got_sampler.sample_batch(16, n_pos)
        want = want_sampler.sample_batch(16, n_pos)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert got_sampler.rng.bit_generator.state == want_sampler.rng.bit_generator.state


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_raw_windows_bit_equal_to_jax(tmp_path, native, dtype):
    paths, targets = _micrographs(tmp_path, [(60, 70), (50, 90)], dtype=dtype)
    kw = dict(radius=2, split="pn", rotate=False, seed=3)
    want = jdata.CropSampler(paths, jcoords.read_coordinates(targets), 30, **kw)
    got = tdata.CropSampler(paths, tcoords.read_coordinates(targets), 30, native=native, **kw)
    assert got.raw_size == want.raw_size == 31
    g, w = got.sample_batch(12, 4), want.sample_batch(12, 4)
    assert g[0].shape == (12, 31, 31)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1], w[1])


def test_read_coordinates_matches_jax(tmp_path):
    coord = tmp_path / "p.txt"
    coord.write_text("image_name\tx_coord\ty_coord\tscore\tsource\n"
                     "a.mrc\t10\t20\t0.5\t1\nb\t30\t40\t-1.25\t0\n\nb\t31\t41\t2\t0\n")
    star = tmp_path / "p.star"
    star.write_text("# header\ndata_images\n\nloop_\n_rlnMicrographName #1\n"
                    "_rlnCoordinateX #2\n_rlnCoordinateY #3\n_rlnParticleScore #4\n"
                    "_rlnVoltage #5\nmic_a.mrc\t10.0\t20.0\t0.5\t300\n"
                    "data001.mrc\t11\t21\t-2\t300\n\ndata_other\nloop_\n")
    box = tmp_path / "mic_c.box"
    box.write_text("10\t20\t30\t30\n5 6 8 8\n\n")
    csv = tmp_path / "p.csv"
    pd.DataFrame({
        "filename": ["a.png", "a.png", "b.png"], "file_size": -1, "file_attributes": "{}",
        "region_count": [2, 2, 0], "region_id": [0, 1, 0],
        "region_shape_attributes": ['{"name":"point","cx":3,"cy":4}',
                                    '{"name":"point","cx":5,"cy":6}', "{}"],
        "region_attributes": ['{"score":"0.5"}', '{"score":"1.5"}', "{}"],
    }).to_csv(csv, index=False)
    for path in (coord, star, box, csv):
        _assert_table_equal(tcoords.read_coordinates(str(path)),
                            jcoords.read_coordinates(str(path)))
    with pytest.raises(tcoords.UnknownFormatError):
        tcoords.read_coordinates(str(tmp_path / "p.xyz"))


def test_write_table_round_trips(tmp_path):
    table = tcoords.Coordinates(np.array(["a", "b"], dtype=object), np.array([1, 2]),
                                np.array([3, 4]), score=np.array([0.5, -1.0]))
    for fmt, name in (("coord", "t.txt"), ("star", "t.star")):
        with open(tmp_path / name, "w") as f:
            tcoords.write_table(f, table, format=fmt, image_ext=".mrc")
        _assert_table_equal(tcoords.read_coordinates(str(tmp_path / name)),
                            jcoords.read_coordinates(str(tmp_path / name)))
        back = tcoords.read_coordinates(str(tmp_path / name))
        assert back.image_name.tolist() == ["a", "b"]
        np.testing.assert_array_equal(back.score, table.score)


def test_find_image_paths_matches_jax(tmp_path):
    paths, _ = _micrographs(tmp_path, [(20, 20), (20, 20)])
    spaced = tmp_path / "dir with space"
    spaced.mkdir()
    cases = {
        "tab.txt": "image_name\tpath\n" + "".join(f"m{i}\t{spaced}/m{i}.mrc\n" for i in range(2)),
        "bare.txt": "image_name   path\na   /tmp/a.mrc\nb   /tmp/b.mrc\n",
        "mixed.txt": "image_name\tpath\na /tmp/a.mrc\nb /tmp/b.mrc\n",
        "ragged.txt": "image_name path\na /tmp/a.mrc\nb\t/tmp/b.mrc\n",
        "source.txt": "image_name\tpath\tsource\na\t/tmp/a.mrc\t1\nb\t/tmp/b.mrc\t0\n",
    }
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        want = jdata.find_image_paths(str(tmp_path / name))
        got = tdata.find_image_paths(str(tmp_path / name))
        assert sorted(got) == sorted(want.columns)
        for col in want.columns:
            assert got[col].tolist() == want[col].tolist(), (name, col)
    got = tdata.find_image_paths(str(tmp_path))
    assert got["path"].tolist() == jdata.find_image_paths(str(tmp_path))["path"].tolist() == paths


@pytest.mark.parametrize("n_images", [1, 2, 4, 5, 6, 9, 13, 23])
def test_kfold_matches_jax(n_images):
    rng = np.random.default_rng(n_images)
    rows = [{"source": int(rng.integers(0, 2)) if n_images > 3 else 0,
             "image_name": f"m{i}", "path": f"/x/m{i}.mrc",
             "count": int(rng.integers(0, 4))} for i in range(n_images)]
    table = pd.DataFrame(rows)
    if min(table.groupby("source").size()) == 1:
        with pytest.raises(ValueError):
            list(jpartition.kfold(3, table, random=np.random.RandomState(42)))
        with pytest.raises(ValueError):
            list(tpartition.kfold(3, rows, random=np.random.RandomState(42)))
        return
    for k in (2, 3, 5):
        want = list(jpartition.kfold(k, table, random=np.random.RandomState(42)))
        got = list(tpartition.kfold(k, rows, random=np.random.RandomState(42)))
        assert len(got) == len(want) == k
        for (gt, gs), (wt, ws) in zip(got, want):
            assert [r["image_name"] for r in gt] == wt["image_name"].tolist()
            assert [r["image_name"] for r in gs] == ws["image_name"].tolist()


def test_qcut_codes_match_pandas():
    for n in range(2, 60):
        ranks = np.arange(1, n + 1, dtype=np.float64)
        want = pd.qcut(pd.Series(ranks), 5, labels=False).to_numpy()
        np.testing.assert_array_equal(tpartition.qcut_codes(ranks, 5), want)


def test_as_mask_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    x, y = rng.integers(0, 60, 12), rng.integers(0, 50, 12)
    for r in (0, 1, 3, 4.5, 7):
        np.testing.assert_array_equal(tmasks.as_mask((50, 60), r, x, y),
                                      jmasks.as_mask((50, 60), r, x, y))
    z = rng.integers(0, 9, 12)
    np.testing.assert_array_equal(tmasks.as_mask((9, 50, 60), 3, x, y, z_coord=z),
                                  jmasks.as_mask((9, 50, 60), 3, x, y, z_coord=z))
    target = (rng.random(500) < 0.2).astype(np.float32)
    pred = np.round(rng.normal(size=500), 1).astype(np.float32)  # with ties
    assert tmetrics.average_precision(target, pred) == jmetrics.average_precision(target, pred)
    for got, want in zip(tmetrics.precision_recall_curve(target, pred, N=120),
                         jmetrics.precision_recall_curve(target, pred, N=120)):
        np.testing.assert_array_equal(got, want)


def test_pixels_given_radius_and_pi_match_jax():
    for r in (1, 2, 3, 5, 7, 14):
        for d in (2, 3):
            assert pixels_given_radius(r, d) == j_pixels_given_radius(r, d)
            assert calculate_pi(20.0, r, 2**19, d) == j_calculate_pi(20.0, r, 2**19, d)
    assert pixels_given_radius(3, 2) == 203


def test_augment_matches_jax_given_the_same_draws():
    rng = np.random.default_rng(2)
    crops = rng.normal(size=(6, 101, 101)).astype(np.float32)
    angles = rng.uniform(0, 360, 6).astype(np.float32)
    hflip = rng.random(6) < 0.5
    vflip = rng.random(6) < 0.5
    want = np.asarray(jax.vmap(jaugment._rotate_nearest)(jnp.asarray(crops), jnp.asarray(angles)))
    off = (101 - 71) // 2
    want = want[:, off:off + 71, off:off + 71]
    want = np.where(hflip[:, None, None], want[:, :, ::-1], want)
    want = np.where(vflip[:, None, None], want[:, ::-1, :], want)
    got = taugment.transform_crops(torch.from_numpy(crops), 71, torch.from_numpy(angles),
                                   torch.from_numpy(hflip), torch.from_numpy(vflip)).numpy()
    np.testing.assert_array_equal(got, want)
    g = torch.Generator().manual_seed(0)
    out = taugment.augment_crops(torch.from_numpy(crops), g, 71)
    assert out.shape == (6, 71, 71)
    # the center pixel survives any rotation and flip
    np.testing.assert_array_equal(out[:, 35, 35].numpy(), crops[:, 50, 50])
