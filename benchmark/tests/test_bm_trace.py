"""The reduction of a profiler trace: busy time, device time by span and
by kernel, idle gaps named by the host span open at the time."""

import json

import pytest

from harness import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_bm_reduce_a_trace(tmp_path):
    events = [
        _x("user_annotation", trace.WINDOW, 0, 1000),
        _x("user_annotation", "pipeline/batch(512, 512)", 100, 600),
        _x("user_annotation", "bm/picker", 150, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=2),
        # a worker thread's launch inside its own span
        _x("user_annotation", "bm/unet", 300, 100, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 5, tid=2, correlation=3),
        _x("kernel", "conv", 200, 100, tid=7, correlation=1),
        _x("kernel", "gmm_em", 450, 150, tid=7, correlation=2),
        _x("kernel", "conv", 500, 50, tid=8, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 900, 200, tid=7),  # runs past the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = trace.reduce(str(path))
    assert r["window_s"] == pytest.approx(1e-3)
    # busy: [200, 300] + [450, 600] + [900, 1000] = 350 us
    assert r["busy_s"] == pytest.approx(350e-6)
    assert r["device_s_by_span"]["bm/picker"] == pytest.approx(100e-6)
    assert r["device_s_by_span"]["bm/unet"] == pytest.approx(50e-6)
    assert r["device_s_by_span"]["pipeline/batch(512, 512)"] == pytest.approx(250e-6)
    assert r["device_s_by_kernel"] == pytest.approx({"conv": 150e-6, "gmm_em": 150e-6,
                                                     "Memcpy HtoD": 200e-6})
    gaps = r["breakdown"]["idle_gaps"]
    assert [round(s * 1e6) for _, s in gaps] == [300, 200, 150]
    # [600, 900] after every span; [0, 200] in the batch's; [300, 450] in
    # the worker's bm/unet, the innermost span open at its middle
    assert [name for name, _ in gaps] == ["no span", "pipeline/batch(512, 512)", "bm/unet"]
    assert r["breakdown"]["device_ops"][0] == ["Memcpy HtoD", pytest.approx(200e-6)]
