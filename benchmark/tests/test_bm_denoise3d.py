"""The ``denoise3d.tomo`` cell on the CPU, cut to a size the CPU runs in
seconds (nf 8, 16^3 tiles of 32^3 windows, two small tomograms): a sound run
reads ``correct``, the U-Net returning its input does not; the tomograms
and weights follow the seed; the configuration holds its run; the readers
of the ``denoise3d/*`` spans."""

import time
from types import SimpleNamespace

import pytest

from harness import cell as cells, spec
from reference import unet3d


def _tiny_cell() -> spec.Cell:
    cell = spec.Cell(spec.load(), "denoise3d.tomo")
    cell.config["denoiser3d"] = dict(cell.config["denoiser3d"], nf=8,
                                     layers=unet3d.layers(8, 7, 3))
    cell.config["path"] = dict(cell.config["path"], patch_size=16, padding=8)
    cell.traffic["shape"] = [20, 24, 40]
    cell.traffic["volumes"] = 2
    return cell


@pytest.mark.parametrize("fault", [False, True])
def test_bm_denoise3d_fault_reads_incorrect(monkeypatch, fault):
    if fault:
        from topaz_tpu_torch.models.denoise import UDenoiseNet

        monkeypatch.setattr(UDenoiseNet, "forward", lambda self, x: x)
    result, compared = cells.run_cell(_tiny_cell(), 2**31 + 303, 0.5, False,
                                      time.perf_counter(), device="cpu")
    assert result["correct"] is (not fault), compared
    assert set(result["metrics"]) == {"setup_s", "denoised_mpix_per_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_bm_tomograms_and_weights_follow_the_seed(tmp_path):
    import numpy as np

    d3 = spec.driver("denoise3d")
    t = dict(_tiny_cell().traffic, shape=[8, 12, 16])
    a, b, c = (d3.volumes(t, s, "cpu") for s in (2**31 + 11, 2**31 + 11, 2**31 + 12))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.shape == (8, 12, 16) and x.dtype == np.float32 for x in a)
    model = _tiny_cell().config["denoiser3d"]
    paths = [str(tmp_path / f"{i}.npz") for i in range(3)]
    for path, seed in zip(paths, (5, 5, 6)):
        d3.write_weights(path, model, seed)
    w = [unet3d.load_npz(p, "cpu") for p in paths]
    assert all(bool((w[0][k] == w[1][k]).all()) for k in w[0])
    assert not bool((w[0]["enc1.0.w"] == w[2]["enc1.0.w"]).all())


def test_bm_denoise3d_config_holds_its_run():
    cell = spec.Cell(spec.load(), "denoise3d.tomo")
    cfg = cell.config
    assert cfg["reduced"] == [] and set(cfg["limits"]) == {"denoise_gap", "missing"}
    m = cfg["denoiser3d"]
    assert (m["nf"], m["base_width"], m["top_width"], m["levels"], m["dims"]) == (48, 7, 3, 5, 3)
    assert m["layers"] == unet3d.layers(48, 7, 3, 5)
    assert (cfg["path"]["patch_size"], cfg["path"]["padding"]) == (96, 48)
    assert "picker" not in cfg and "denoiser" not in cfg
    assert {x["name"] for x in cell.per_layer} == {
        "device_idle_share.tomo", "mfu.tomo", "unet3d.device_ms.tomo", "patch.device_ms.tomo",
        "transfer.device_ms.tomo"}


def _run(completed, spans):
    return SimpleNamespace(driver=SimpleNamespace(completed=completed),
                           trace=None if spans is None else {"device_s_by_span": spans})


def test_bm_denoise3d_span_readers():
    spans = {"denoise3d/upload": 0.02, "denoise3d/fetch": 0.06, "denoise3d/patch": 41.0,
             "denoise3d/unet": 40.0}
    read = {n: spec.reader(n) for n in ("unet3d.device_ms.tomo", "patch.device_ms.tomo",
                                        "transfer.device_ms.tomo")}
    assert read["unet3d.device_ms.tomo"](_run(2, spans)) == pytest.approx(20000.0)
    # the patch loop outside the forwards nested in it
    assert read["patch.device_ms.tomo"](_run(2, spans)) == pytest.approx(500.0)
    assert read["transfer.device_ms.tomo"](_run(2, spans)) == pytest.approx(40.0)
    for r in read.values():
        assert r(_run(2, None)) is None  # an untraced run
        assert r(_run(0, spans)) is None
        assert r(_run(2, {"bm/unet": 1.0})) is None  # a program without the spans


def test_bm_mfu_tomo_counts_the_published_grid():
    cell = spec.Cell(spec.load(), "denoise3d.tomo")
    run = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          driver=SimpleNamespace(completed=3), window_s=60.0)
    # 3 tomograms of 96 patches of 192^3 at 675,886.17 operations a voxel
    want = 100 * 3 * 96 * 192 ** 3 * 675_886.171875 / 60.0 / 67e12
    assert spec.reader("mfu.tomo")(run) == pytest.approx(want)
