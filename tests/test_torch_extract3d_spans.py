"""What ``extract.pick_volume`` records: its ``extract3d/*`` stage spans
(names, counts and order) and the counters of its work (``extract``'s
``volumes_picked`` and ``output_voxels``, ``models.tiling``'s
``tiles_scored`` and ``network_voxels``, ``ops.nms.rounds``), for a known
tile grid, on the CPU; and that 2D tiled scoring records no such span.
No JAX."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch import extract
from topaz_tpu_torch.models import tiling
from topaz_tpu_torch.models.factory import new_picker
from topaz_tpu_torch.ops import nms
from topaz_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (12, 16, 20)
TILE = 8
GRID = 2 * 2 * 3        # ceil(n / 8) an axis
WINDOW = TILE + 70      # the tile and the receptive field's halo
NAMES = ("extract3d/tile", "extract3d/score", "extract3d/nms", "extract3d/fetch")


@pytest.fixture
def picker(monkeypatch):
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    profiling.reset()
    yield new_picker("resnet8", units=4, dims=3, seed=3, device="cpu")
    profiling.reset()


def _counters():
    return {"volumes_picked": extract.volumes_picked, "output_voxels": extract.output_voxels,
            "tiles_scored": tiling.tiles_scored, "network_voxels": tiling.network_voxels,
            "rounds": nms.rounds}


@pytest.mark.parametrize("batch_size", [2, 5])
def test_pick_volume_spans_and_counters(picker, batch_size):
    vol = np.random.default_rng(7).normal(size=SHAPE).astype(np.float32)
    with torch.inference_mode():
        t = float(torch.quantile(picker(torch.from_numpy(vol)[None])[0].reshape(-1), 0.9))
    before = _counters()
    scores, coords = extract.pick_volume(picker, vol, 3, t, patch_size=TILE,
                                         batch_size=batch_size)
    assert len(scores) > 0
    counted = {k: v - before[k] for k, v in _counters().items()}
    batches = -(-GRID // batch_size)
    spans = {n: profiling.records(n) for n in NAMES}
    assert {n: len(s) for n, s in spans.items()} == {
        "extract3d/tile": batches, "extract3d/score": batches, "extract3d/nms": 1,
        "extract3d/fetch": 1}
    # a batch cut and uploaded, then scored; the rounds after the last
    # batch, the fetch after the rounds
    order = [s for b in range(batches)
             for s in (spans["extract3d/tile"][b], spans["extract3d/score"][b])]
    order += [spans["extract3d/nms"][0], spans["extract3d/fetch"][0]]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert all(s.parent is None for s in order)
    rounds = counted.pop("rounds")
    assert rounds >= 1
    # the ragged last batch is filled with copies of its last window
    assert counted == {"volumes_picked": 1, "output_voxels": int(np.prod(SHAPE)),
                       "tiles_scored": GRID,
                       "network_voxels": batches * batch_size * WINDOW ** 3}


def test_2d_tiled_scoring_records_no_extract3d_span(picker):
    vol = np.random.default_rng(8).normal(size=SHAPE).astype(np.float32)
    before = tiling.tiles_scored
    picker2d = new_picker("resnet8", units=4, dims=2, seed=3, device="cpu")
    tiling.predict_in_patches(picker2d, vol[0], TILE, 2)
    assert all(profiling.count(n) == 0 for n in NAMES)
    # the 3D tiling records its spans for any caller: 12 tiles in 6 batches
    tiling.classify_patches_3d(picker, vol, TILE, 2)
    assert [profiling.count(n) for n in NAMES] == [6, 6, 0, 0]
    # both count their tiles: 2 x 3 of the plane, 12 of the volume
    assert tiling.tiles_scored - before == 6 + GRID
