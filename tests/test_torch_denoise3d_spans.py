"""What ``Denoise3D`` records: its ``denoise3d/*`` stage spans (names,
counts, nesting and order) and its module counters, on a tiny volume on
the CPU, in the resident, streaming and whole-volume routes. No JAX."""

import numpy as np
import pytest

import topaz_tpu_torch.denoise as denoise
from topaz_tpu_torch.denoise import Denoise3D
from topaz_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (12, 16, 20)
S, P = 8, 4             # 16^3 windows
GRID = 2 * 2 * 3        # ceil(n / 8) an axis
NAMES = ("denoise3d/upload", "denoise3d/patch", "denoise3d/unet", "denoise3d/fetch",
         "denoise3d/extract", "denoise3d/stitch")
COUNTERS = ("patches_denoised", "network_voxels", "output_voxels", "resident_volumes",
            "streaming_volumes")


@pytest.fixture
def model(monkeypatch):
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    profiling.reset()
    yield Denoise3D.from_arch("unet-small", nf=4, base_width=3, device="cpu", seed=1)
    profiling.reset()


def _run(model, **kw):
    vol = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    before = {c: getattr(denoise, c) for c in COUNTERS}
    out = model.denoise(vol, verbose=False, **kw)
    assert out.shape == SHAPE
    spans = {n: profiling.records(n) for n in NAMES}
    return spans, {c: getattr(denoise, c) - before[c] for c in COUNTERS}


def test_resident_route_spans_each_patch(model):
    spans, counted = _run(model, patch_size=S, padding=P, device_resident=True)
    assert {n: len(s) for n, s in spans.items()} == {
        "denoise3d/upload": 1, "denoise3d/patch": GRID, "denoise3d/unet": GRID,
        "denoise3d/fetch": 1, "denoise3d/extract": 0, "denoise3d/stitch": 0}
    # each forward inside its patch's span, the patches between upload and fetch
    for patch, unet in zip(spans["denoise3d/patch"], spans["denoise3d/unet"]):
        assert unet.parent == "denoise3d/patch" and patch.parent is None
        assert patch.start_ns <= unet.start_ns <= unet.end_ns <= patch.end_ns
    assert spans["denoise3d/upload"][0].end_ns <= spans["denoise3d/patch"][0].start_ns
    assert spans["denoise3d/patch"][-1].end_ns <= spans["denoise3d/fetch"][0].start_ns
    assert counted == {"patches_denoised": GRID, "network_voxels": GRID * 16 ** 3,
                       "output_voxels": int(np.prod(SHAPE)), "resident_volumes": 1,
                       "streaming_volumes": 0}


def test_streaming_route_spans_each_batch(model):
    batch = 5
    batches = -(-GRID // batch)
    spans, counted = _run(model, patch_size=S, padding=P, device_resident=False,
                          batch_size=batch)
    per_batch = ("denoise3d/extract", "denoise3d/upload", "denoise3d/unet", "denoise3d/fetch",
                 "denoise3d/stitch")
    assert {n: len(s) for n, s in spans.items()} == {
        n: batches if n in per_batch else 0 for n in NAMES}
    # one batch's spans in the route's order, one batch after another
    order = [s for b in range(batches) for s in (spans[n][b] for n in per_batch)]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert all(s.parent is None for s in order)
    # the last batch is filled with copies of its last patch
    assert counted == {"patches_denoised": GRID, "network_voxels": batches * batch * 16 ** 3,
                       "output_voxels": int(np.prod(SHAPE)), "resident_volumes": 0,
                       "streaming_volumes": 1}


def test_whole_volume_spans_one_forward(model):
    spans, counted = _run(model, patch_size=0)
    assert {n: len(s) for n, s in spans.items()} == {
        "denoise3d/upload": 1, "denoise3d/patch": 0, "denoise3d/unet": 1,
        "denoise3d/fetch": 1, "denoise3d/extract": 0, "denoise3d/stitch": 0}
    n = int(np.prod(SHAPE))
    assert counted == {"patches_denoised": 0, "network_voxels": n, "output_voxels": n,
                       "resident_volumes": 0, "streaming_volumes": 0}
