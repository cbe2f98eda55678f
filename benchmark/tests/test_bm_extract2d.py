"""The ``extract.k3_s4`` cell on the CPU, cut to a size the CPU runs in
seconds (a units-4 ResNet16, three 96 x 128 frames cropped by 2, r = 3): a
sound run reads ``correct``, a program whose picks crowd or whose scores
are off does not; the inputs, weights and threshold follow the seed; the
configuration holds its run; the readers of the ``extract/*`` spans and the
operation count."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from harness import cell as cells, check, inputs, spec
from reference import counts, model

CELL = "extract.k3_s4"
LIMIT = spec.Cell(spec.load(), CELL).config["limits"]["pick_gap"]


def _driver():
    return spec.driver("extract2d")


def _tiny_cell() -> spec.Cell:
    cell = spec.Cell(spec.load(), CELL)
    cell.config["picker_seeded"] = dict(cell.config["picker_seeded"], units=4,
                                        layers=_driver().layers(4))
    cell.config["path"] = dict(cell.config["path"], scale=2, radius=3, threshold_rank=10)
    cell.traffic["cameras"] = [dict(cell.traffic["cameras"][0], shape=[96, 128], files=3)]
    cell.traffic["micrograph"] = dict(cell.traffic["micrograph"], particle_radius_px=6)
    return cell


def _crowd(s, c):
    """The second pick moved next to the first: closer than the radius."""
    c = c.copy()
    if len(c) > 1:
        c[1] = c[0] + np.array([1, 0] if c[0][0] == 0 else [-1, 0], dtype=c.dtype)
    return s, c


@pytest.mark.parametrize("fault", [None, "crowded", "scores"])
def test_bm_extract2d_fault_reads_incorrect(monkeypatch, fault):
    from topaz_tpu_torch import extract

    real = extract.non_maximum_suppression
    if fault == "crowded":
        monkeypatch.setattr(extract, "non_maximum_suppression",
                            lambda x, r, **kw: _crowd(*real(x, r, **kw)))
    elif fault == "scores":  # each score 1e-3 of its size off the map
        def nms(x, r, **kw):
            s, c = real(x, r, **kw)
            return s * (1 + 1e-3) + 1e-3, c
        monkeypatch.setattr(extract, "non_maximum_suppression", nms)
    result, compared = cells.run_cell(_tiny_cell(), 2**31 + 504, 0.5, False,
                                      time.perf_counter(), device="cpu")
    assert result["correct"] is (fault is None), compared
    if fault is None:
        assert compared["pick_gap"]["value"] <= 1e-5
    elif fault == "crowded":
        assert compared["pick_gap"]["value"] == check.FAULT
    else:
        assert compared["pick_gap"]["value"] > LIMIT
    assert compared["missing"]["value"] == 0
    assert set(result["metrics"]) == {"setup_s", "picked_micrographs_per_s"}
    assert result["attempted"] >= 3 and result["attempted"] % 3 == 0 and result["failed"] == 0


def test_bm_extract2d_traced_run_reads_its_spans():
    result, _ = cells.run_cell(_tiny_cell(), 2**31 + 505, 0.5, True, time.perf_counter(),
                               device="cpu")
    names = {"picker.device_ms.extract", "nms.device_ms.extract", "mfu.extract",
             "device_idle_share.extract", "io.host_ms.extract"}
    # no card: the device readers find nothing; the host clock's share and
    # the program's host spans do
    assert set(result["metrics"]) == {"mfu.extract", "io.host_ms.extract"}
    assert result["metrics"]["io.host_ms.extract"]["value"] > 0
    assert {m["name"] for m in spec.Cell(spec.load(), CELL).per_layer} == names


def test_bm_extract2d_inputs_weights_and_threshold_follow_the_seed(tmp_path):
    d = _driver()
    cell = _tiny_cell()
    drivers = []
    for k, seed in enumerate((2**31 + 11, 2**31 + 11, 2**31 + 12)):
        work = tmp_path / str(k)
        work.mkdir()
        drv = d.Driver(cell.config, dict(cell.traffic, warm_passes=0), seed, "cpu", str(work))
        drv.setup()
        drivers.append(drv)
    a, b, c = ([np.array(inputs.read_mrc(p)) for p in drv.paths] for drv in drivers)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    for x in a:  # cropped by 2 and standardized
        assert x.shape == (48, 64) and x.dtype == np.float32
        assert abs(float(x.mean())) < 1e-5 and abs(float(x.std()) - 1) < 1e-5
    w = [model.load_npz(drv.weights, "cpu") for drv in drivers]
    assert all(bool((w[0][k] == w[1][k]).all()) for k in w[0])
    assert not bool((w[0]["features.0.conv_w"] == w[2]["features.0.conv_w"]).all())
    assert drivers[0].threshold == drivers[1].threshold != drivers[2].threshold
    # the rule on the reference's map of the warm micrograph: the same
    # threshold, up to the map's rounding
    maps = d.ReferenceMaps(cell.config, drivers[0].weights, "cpu", False)
    t = d.reference_threshold(maps(drivers[0].paths[0]), 3, 10)
    assert t == pytest.approx(drivers[0].threshold, rel=1e-5, abs=1e-5)


def test_bm_extract2d_config_holds_its_run():
    cell = spec.Cell(spec.load(), CELL)
    cfg = cell.config
    assert cfg["reduced"] == [] and set(cfg["limits"]) == {"pick_gap", "missing"}
    m = cfg["picker_seeded"]
    assert (m["arch"], m["units"], m["dims"], m["bn"]) == ("resnet16", 64, 2, False)
    assert m["layers"] == _driver().layers(64)
    assert counts.picker_flops_per_pixel(m["layers"]) == 3_652_224
    assert model.receptive_field(m["layers"]) == 91
    path = cfg["path"]
    assert (path["scale"], path["radius"], path["batch_size"], path["threshold_rank"]) == \
        (4, 8, 1, 2000)
    assert "picker" not in cfg and "denoiser" not in cfg
    assert cell.traffic["driver"] == "extract2d" and cell.chips == 1
    assert cell.traffic["cameras"] == [{"name": "k3", "shape": [4092, 5760], "files": 16}]
    assert {m["name"] for m in cell.end_to_end} == {"picked_micrographs_per_s", "setup_s"}


def test_bm_extract2d_answers_parse_back_exactly(tmp_path):
    d = _driver()
    s = np.array([3.1415927, -0.1, 1e-8, 12345.679], dtype=np.float32)
    table = tmp_path / "picks.txt"
    with open(table, "w") as f:
        print("image_name\tx_coord\ty_coord\tscore", file=f)
        for i, v in enumerate(s):
            print(f"a\t{i}\t{2 * i}\t{v}", file=f)
    answers = d.read_answers([str(table), str(table)], ["a", "b"])
    assert len(answers["a"]) == 1 and answers["b"] == {()}
    scores, coords = d.parse_answer(next(iter(answers["a"])))
    assert scores.dtype == np.float32 and np.array_equal(scores, s)
    assert coords.tolist() == [[i, 2 * i] for i in range(4)]
    assert [len(x) for x in d.parse_answer(())] == [0, 0]


def _run(completed, spans):
    return SimpleNamespace(driver=SimpleNamespace(completed=completed),
                           trace=None if spans is None else {"device_s_by_span": spans})


def test_bm_extract2d_span_readers():
    spans = {"extract/upload": 0.05, "extract/score": 16.0, "extract/nms": 0.8,
             "extract/fetch": 0.01}
    read = {n: spec.reader(n) for n in ("picker.device_ms.extract", "nms.device_ms.extract")}
    assert read["picker.device_ms.extract"](_run(80, spans)) == pytest.approx(200.0)
    assert read["nms.device_ms.extract"](_run(80, spans)) == pytest.approx(10.0)
    for r in read.values():
        assert r(_run(2, None)) is None  # an untraced run
        assert r(_run(0, spans)) is None
        assert r(_run(2, {"extract3d/score": 1.0})) is None  # a program without the spans


def test_bm_io_reader_takes_the_window_reads_and_writes(monkeypatch):
    from topaz_tpu_torch.utils import profiling

    now = [0]
    monkeypatch.setattr(profiling, "_clock", lambda: now[0])
    profiling.reset()
    try:
        def span(name, start, end):
            now[0] = start
            with profiling.stage(name):
                now[0] = end

        t = 0
        for ms in (9, 9, 2, 4):  # two warm micrographs, two in the window
            span("extract/read", t, t + ms * 1_000_000)
            span("extract/write", t + 10**8, t + 10**8 + 1_000_000)
            t += 10**9
        read = spec.reader("io.host_ms.extract")
        assert read(_run(2, None)) == pytest.approx((2 + 4 + 2 * 1) / 2)
        assert read(_run(5, None)) is None  # more micrographs than samples
        profiling.reset()
        assert read(_run(2, None)) is None  # a program without the spans
    finally:
        profiling.reset()


def test_bm_mfu_extract_counts_valid_pixels():
    cell = spec.Cell(spec.load(), CELL)
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          driver=SimpleNamespace(completed=32, pixels=32 * 1023 * 1440),
                          window_s=60.0)
    want = 100 * 32 * 1023 * 1440 * 3_652_224 / 60.0 / 67e12
    assert spec.reader("mfu.extract")(run) == pytest.approx(want)
