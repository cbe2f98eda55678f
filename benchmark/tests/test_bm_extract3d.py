"""The ``extract3d.tomo`` cell on the CPU, cut to a size the CPU runs in
seconds (a units-8 picker, 8^3 tiles, two small tomograms): a sound run
reads ``correct``, a program whose scores or radius are off does not; the
tomograms and weights follow the seed; the configuration holds its run;
the readers of the ``extract3d/*`` spans and the operation count."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from harness import cell as cells, spec
from reference import picker3d


def _tiny_cell() -> spec.Cell:
    cell = spec.Cell(spec.load(), "extract3d.tomo")
    cell.config["picker3d"] = dict(cell.config["picker3d"], units=8, layers=picker3d.layers(8))
    cell.config["path"] = dict(cell.config["path"], patch_size=8, batch_size=2, radius=3,
                               threshold_quantile=0.99, slab=8)
    cell.traffic["shape"] = [12, 16, 20]
    cell.traffic["volumes"] = 2
    cell.traffic["tomogram"] = dict(cell.traffic["tomogram"], particle_radius_px=3)
    return cell


@pytest.mark.parametrize("fault", [None, "scores", "radius"])
def test_bm_extract3d_fault_reads_incorrect(monkeypatch, fault):
    from topaz_tpu_torch import extract

    real = extract.non_maximum_suppression_3d
    if fault == "scores":  # each score 1e-3 of its size off the map
        def nms(x, r, **kw):
            s, c = real(x, r, **kw)
            return s * (1 + 1e-3) + 1e-3, c
        monkeypatch.setattr(extract, "non_maximum_suppression_3d", nms)
    elif fault == "radius":  # picks one voxel closer than the radius allows
        monkeypatch.setattr(extract, "non_maximum_suppression_3d",
                            lambda x, r, **kw: real(x, r - 2, **kw))
    result, compared = cells.run_cell(_tiny_cell(), 2**31 + 404, 0.5, False,
                                      time.perf_counter(), device="cpu")
    assert result["correct"] is (fault is None), compared
    if fault is None:
        assert compared["pick_gap"]["value"] <= 1e-5
    assert set(result["metrics"]) == {"setup_s", "picked_micrographs_per_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_bm_extract3d_traced_run_reads_its_spans():
    result, _ = cells.run_cell(_tiny_cell(), 2**31 + 405, 0.5, True, time.perf_counter(),
                               device="cpu")
    names = {"picker3d.device_ms.extract3d", "nms3d.device_ms.extract3d", "mfu.extract3d",
             "device_idle_share.extract3d"}
    # no card: the device readers find nothing, the host clock's share does
    assert set(result["metrics"]) == {"mfu.extract3d"}
    assert {m["name"] for m in spec.Cell(spec.load(), "extract3d.tomo").per_layer} == names


def test_bm_picked_tomograms_and_weights_follow_the_seed(tmp_path):
    d = spec.driver("extract3d")
    t = dict(_tiny_cell().traffic, shape=[8, 12, 16])
    a, b, c = (d.volumes(t, s, "cpu") for s in (2**31 + 11, 2**31 + 11, 2**31 + 12))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    for x in a:  # standardized
        assert x.shape == (8, 12, 16) and x.dtype == np.float32
        assert abs(float(x.mean())) < 1e-5 and abs(float(x.std()) - 1) < 1e-5
    model = _tiny_cell().config["picker3d"]
    paths = [str(tmp_path / f"{i}.npz") for i in range(3)]
    for path, seed in zip(paths, (5, 5, 6)):
        d.write_weights(path, model, seed)
    w = [picker3d.load_npz(p, "cpu") for p in paths]
    assert all(bool((w[0][k] == w[1][k]).all()) for k in w[0])
    assert not bool((w[0]["features.0.conv_w"] == w[2]["features.0.conv_w"]).all())
    assert w[0]["features.2.proj_w"].shape == (16, 8, 1, 1, 1)
    assert w[0]["classifier.w"].shape == (1, 32, 1, 1, 1)


def test_bm_extract3d_config_holds_its_run():
    cell = spec.Cell(spec.load(), "extract3d.tomo")
    cfg = cell.config
    assert cfg["reduced"] == [] and set(cfg["limits"]) == {"pick_gap", "missing"}
    m = cfg["picker3d"]
    assert (m["arch"], m["units"], m["dims"], m["bn"]) == ("resnet8", 32, 3, True)
    assert m["layers"] == picker3d.layers(32)
    assert (cfg["path"]["patch_size"], cfg["path"]["batch_size"], cfg["path"]["radius"]) == \
        (96, 1, 8)
    assert "picker" not in cfg and "denoiser" not in cfg
    assert cell.traffic["shape"] == [192, 512, 720] and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"picked_micrographs_per_s", "setup_s"}


def _run(completed, spans):
    return SimpleNamespace(driver=SimpleNamespace(completed=completed),
                           trace=None if spans is None else {"device_s_by_span": spans})


def test_bm_extract3d_span_readers():
    spans = {"extract3d/tile": 0.5, "extract3d/score": 40.0, "extract3d/nms": 3.0,
             "extract3d/fetch": 0.01}
    read = {n: spec.reader(n) for n in ("picker3d.device_ms.extract3d",
                                        "nms3d.device_ms.extract3d")}
    assert read["picker3d.device_ms.extract3d"](_run(2, spans)) == pytest.approx(20000.0)
    assert read["nms3d.device_ms.extract3d"](_run(2, spans)) == pytest.approx(1500.0)
    for r in read.values():
        assert r(_run(2, None)) is None  # an untraced run
        assert r(_run(0, spans)) is None
        assert r(_run(2, {"bm/picker": 1.0})) is None  # a program without the spans


def test_bm_mfu_extract3d_counts_valid_voxels():
    cell = spec.Cell(spec.load(), "extract3d.tomo")
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          driver=SimpleNamespace(completed=3), window_s=60.0)
    assert picker3d.picker3d_flops_per_voxel(cell.config["picker3d"]["layers"]) == 2_793_152
    want = 100 * 3 * 192 * 512 * 720 * 2_793_152 / 60.0 / 67e12
    assert spec.reader("mfu.extract3d")(run) == pytest.approx(want)
