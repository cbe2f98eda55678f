"""What ``extract.extract_particles`` records on the route that takes one
micrograph at a time (``batch_size`` 1): its ``extract/*`` stage spans
(names, counts and order), the counters of its work (``extract``'s
``micrographs_picked`` and ``output_pixels``, ``ops.nms.rounds``), the
radius search's NMS spans; and that the batched pipeline records none of
them. Tiny micrographs on the CPU; no JAX."""

import numpy as np
import pytest
import torch

from topaz_tpu_torch import extract
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.models.factory import new_picker, save_picker
from topaz_tpu_torch.ops import nms
from topaz_tpu_torch.pipeline import MicrographPipeline
from topaz_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(40, 48), (32, 56), (48, 40)]
NAMES = ("extract/read", "extract/upload", "extract/score", "extract/nms", "extract/fetch",
         "extract/write")


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(26)
    paths = []
    for i, shape in enumerate(SHAPES):
        paths.append(str(tmp_path / f"mic{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=shape).astype(np.float32))
    return paths


@pytest.fixture
def model(tmp_path):
    path = str(tmp_path / "picker.npz")
    save_picker(path, new_picker("resnet16", units=4, seed=5, device="cpu"))
    return path


def _counters():
    return {"micrographs_picked": extract.micrographs_picked,
            "output_pixels": extract.output_pixels, "rounds": nms.rounds,
            "volumes_picked": extract.volumes_picked}


def test_extract_spans_and_counters_each_micrograph(tmp_path, clean, files, model):
    before = _counters()
    out = str(tmp_path / "picks.txt")
    extract.extract_particles(files, model=model, threshold=0.0, radius=3, batch_size=1,
                              output=out, device="cpu")
    with open(out) as f:
        assert len(f.readlines()) > 1 + len(files)  # picks in every micrograph
    spans = {n: profiling.records(n) for n in NAMES}
    assert {n: len(s) for n, s in spans.items()} == {n: len(files) for n in NAMES}
    # each micrograph read, uploaded, scored, suppressed, fetched and
    # written before the next is read
    order = [spans[n][i] for i in range(len(files)) for n in NAMES]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert all(s.parent is None and s.batch is None for s in order)
    counted = {k: v - before[k] for k, v in _counters().items()}
    assert counted.pop("rounds") >= len(files)
    assert counted == {"micrographs_picked": len(files),
                       "output_pixels": sum(h * w for h, w in SHAPES), "volumes_picked": 0}


def test_extract_nms_spans_every_caller(clean):
    """The NMS spans belong to ``non_maximum_suppression``: a caller outside
    ``extract_particles``, such as the radius search, records them too."""
    score = torch.from_numpy(np.random.default_rng(3).normal(size=(24, 30)).astype(np.float32))
    for r in (2, 4):
        extract.non_maximum_suppression(score, r, threshold=0.5, device="cpu")
    assert [profiling.count(n) for n in NAMES] == [0, 0, 0, 2, 2, 0]
    assert profiling.records("extract/nms")[0].end_ns <= \
        profiling.records("extract/fetch")[0].start_ns


def test_pipeline_records_no_extract_span(clean, files):
    before = extract.micrographs_picked
    pipe = MicrographPipeline(model="resnet8_u32", scale=1, radius=3, threshold=0.0,
                              normalize=False, device="cpu")
    out = list(pipe.process(files, batch_size=2))
    assert len(out) == len(files)
    assert profiling.count("pipeline/nms") == 2
    assert all(profiling.count(n) == 0 for n in NAMES)
    assert extract.micrographs_picked == before
