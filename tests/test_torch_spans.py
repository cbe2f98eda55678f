"""The port's stage spans: what ``MicrographPipeline.process`` and
``denoise_image`` record (names, counts, threads, enclosing stages and
batch numbers), ``denoise_image``'s and the resident ``Denoise3D``'s with
their uploads staged as to a card, the bounded record behind
``utils/profiling``, the ``TOPAZ_TIMINGS`` printout and the
``TOPAZ_PROFILE`` trace of a CLI command. Tiny micrographs on the CPU; no
JAX."""

import json
import threading

import numpy as np
import pytest
import torch

from topaz_tpu_torch import device
from topaz_tpu_torch.cli.main import main
from topaz_tpu_torch.denoise import Denoise, Denoise3D, denoise_image
from topaz_tpu_torch.io import mrc
from topaz_tpu_torch.pipeline import MicrographPipeline
from topaz_tpu_torch.utils import profiling
from torch_staging import cpu_staging  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

# two buckets at scale 2: 4 micrographs of (64, 64), 3 of (64, 96) -> (64, 128)
SHAPES = [(128, 128)] * 4 + [(128, 192)] * 3
BATCH = 2
BATCHES = [2, 2]  # a bucket's batches
DISPATCH = ("pipeline/plan", "pipeline/wait", "pipeline/upload", "pipeline/prep",
            "pipeline/normalize", "pipeline/score", "pipeline/nms", "pipeline/denoise",
            "pipeline/fetch")


@pytest.fixture
def micrographs(tmp_path):
    rng = np.random.default_rng(18)
    paths = []
    for i, shape in enumerate(SHAPES):
        paths.append(str(tmp_path / f"m{i}.mrc"))
        mrc.write(paths[-1], rng.normal(size=shape).astype(np.float32))
    return paths


@pytest.fixture
def clean(monkeypatch):
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    monkeypatch.delenv("TOPAZ_PROFILE", raising=False)
    profiling.reset()
    yield
    profiling.reset()


def _by_name():
    names = {"pipeline/read", *DISPATCH}
    return {n: profiling.records(n) for n in names}


@pytest.mark.parametrize("host_downsample,denoise", [(False, None), (True, None),
                                                     (False, "unet-small")])
def test_pipeline_spans_each_micrograph_and_batch(micrographs, clean, host_downsample, denoise):
    pipe = MicrographPipeline(model="resnet8_u32", denoise_model=denoise, scale=2, radius=3,
                              threshold=0.0, num_workers=2, host_downsample=host_downsample,
                              device="cpu")
    with profiling.stage("test/outer"):
        out = list(pipe.process(micrographs, batch_size=BATCH))
    assert len(out) == len(micrographs)
    n_batches = sum(BATCHES)
    slots = n_batches * BATCH  # a partial batch is filled by repetition
    spans = _by_name()
    counts = {n: len(s) for n, s in spans.items()}
    assert counts == {
        "pipeline/plan": 1,
        "pipeline/read": len(micrographs),
        "pipeline/wait": n_batches + 1,  # the last wait finds the end
        "pipeline/upload": n_batches if host_downsample else slots,
        "pipeline/prep": 0 if host_downsample else slots,
        "pipeline/normalize": n_batches, "pipeline/score": n_batches,
        "pipeline/nms": n_batches, "pipeline/fetch": n_batches,
        "pipeline/denoise": n_batches if denoise else 0,
    }
    assert {n: profiling.count(n) for n in counts} == counts
    assert not [n for n in profiling.timings() if n.startswith("pipeline/batch")]

    here = threading.get_native_id()
    for name in DISPATCH:
        for s in spans[name]:
            assert s.thread == here and s.parent == "test/outer", s
            assert s.start_ns <= s.end_ns
    for s in spans["pipeline/read"]:
        assert s.thread != here, s
        assert s.parent is None
    # one batch's spans join up by its number
    assert [s.batch for s in spans["pipeline/plan"]] == [None]
    assert [s.batch for s in spans["pipeline/wait"]] == list(range(n_batches)) + [None]
    for name in ("pipeline/normalize", "pipeline/score", "pipeline/nms", "pipeline/fetch"):
        assert [s.batch for s in spans[name]] == list(range(n_batches)), name
    reads = [s.batch for s in spans["pipeline/read"]]
    assert sorted(reads) == [0, 0, 1, 1, 2, 2, 3]
    per = BATCH if not host_downsample else 1
    assert sorted(s.batch for s in spans["pipeline/upload"]) == \
        sorted(b for b in range(n_batches) for _ in range(per))
    # each batch's reads end before the wait that hands the batch over ends,
    # and its upload starts after that
    for b in range(n_batches):
        wait = spans["pipeline/wait"][b]
        assert max(s.end_ns for s in spans["pipeline/read"] if s.batch == b) <= wait.end_ns
        assert min(s.start_ns for s in spans["pipeline/upload"] if s.batch == b) >= wait.end_ns


def test_denoise_image_records_its_four_spans(clean):
    model = Denoise("unet-small", device="cpu")
    mic = np.random.default_rng(1).normal(size=(96, 80)).astype(np.float32)
    out = denoise_image(mic, [model])
    assert out.shape == mic.shape
    names = ["denoise/upload", "denoise/filter", "denoise/unet", "denoise/fetch"]
    spans = [profiling.records(n) for n in names]
    assert [len(s) for s in spans] == [1, 1, 1, 1]
    order = [s[0] for s in spans]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert all(s.parent is None and s.batch is None for s in order)


def _staged(fn):
    before = device.staged_uploads
    out = fn()
    return out, device.staged_uploads - before


def test_denoise_image_spans_hold_on_the_staged_route(clean, cpu_staging):
    """The micrograph goes through the staging ring inside ``denoise/upload``
    (numpy arrays routed as to a card); the four spans and the output stand
    as on the plain route."""
    model = Denoise("unet-small", device="cpu")
    mic = np.random.default_rng(2).normal(size=(520, 512)).astype(np.float32)  # > 1 MiB
    out, staged = _staged(lambda: denoise_image(mic, [model]))
    assert staged == 1
    names = ["denoise/upload", "denoise/filter", "denoise/unet", "denoise/fetch"]
    order = [profiling.records(n) for n in names]
    assert [len(s) for s in order] == [1, 1, 1, 1]
    order = [s[0] for s in order]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    plain, staged = _staged(lambda: denoise_image(torch.from_numpy(mic), [model]))
    assert staged == 0
    np.testing.assert_array_equal(out, plain)


def test_resident_denoise3d_spans_hold_on_the_staged_route(clean, cpu_staging):
    """The resident route's volume goes through the staging ring inside
    ``denoise3d/upload``, its output comes back inside ``denoise3d/fetch``."""
    model = Denoise3D.from_arch("unet-small", nf=4, base_width=3, device="cpu", seed=1)
    vol = np.random.default_rng(3).normal(size=(64, 64, 64)).astype(np.float32)  # 1 MiB
    out, staged = _staged(lambda: model.denoise(vol, patch_size=64, padding=4,
                                                verbose=False, device_resident=True))
    assert staged == 1 and model.last_route == "resident" and out.shape == vol.shape
    spans = {n: profiling.records(f"denoise3d/{n}") for n in ("upload", "patch", "fetch")}
    assert {n: len(s) for n, s in spans.items()} == {"upload": 1, "patch": 1, "fetch": 1}
    assert spans["upload"][0].end_ns <= spans["patch"][0].start_ns
    assert spans["patch"][0].end_ns <= spans["fetch"][0].start_ns


def test_the_record_is_bounded_and_its_totals_exact(clean, monkeypatch):
    ticks = iter(range(0, 10**9, 7))
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    monkeypatch.setattr(profiling, "RING", 5)
    for i in range(12):
        with profiling.stage("unit/many", batch=i):
            pass
    t = profiling.timings()["unit/many"]
    assert t["count"] == 12 and profiling.count("unit/many") == 12
    assert t["total_s"] == pytest.approx(12 * 7e-9)  # each span two ticks apart
    kept = profiling.records("unit/many")
    assert [s.batch for s in kept] == list(range(7, 12))
    assert profiling.samples("unit/many") == pytest.approx([7e-9] * 5)
    assert profiling.records("unit/none") == [] and profiling.count("unit/none") == 0


def test_threads_lose_no_count_or_total(clean):
    """Loader threads end spans of one name at once: under a short switch
    interval the count and total still add up exactly."""
    import sys

    threads, each = 16, 250  # every sample stays in the ring
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.stage("unit/shared"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    kept = profiling.records("unit/shared")
    assert profiling.count("unit/shared") == len(kept) == threads * each
    assert profiling.timings()["unit/shared"]["total_s"] == \
        pytest.approx(sum(s.end_ns - s.start_ns for s in kept) / 1e9, rel=1e-12)
    assert len({s.thread for s in kept}) > 1 and all(s.parent is None for s in kept)


def test_a_span_costs_no_profiler_call_while_no_profiler_runs(clean, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.stage("unit/off"):
        pass
    assert profiling.count("unit/off") == 1


def test_nested_stages_name_their_parent_and_a_batch_set_inside(clean):
    with profiling.stage("unit/outer"):
        with profiling.stage("unit/inner") as span:
            span.batch = 3
        with pytest.raises(ValueError):
            with profiling.stage("unit/fails"):
                raise ValueError("inside")
    with profiling.stage("unit/after"):
        pass
    inner, = profiling.records("unit/inner")
    fails, = profiling.records("unit/fails")
    outer, = profiling.records("unit/outer")
    after, = profiling.records("unit/after")
    assert (inner.parent, inner.batch, fails.parent) == ("unit/outer", 3, "unit/outer")
    assert outer.parent is None and after.parent is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_timings_print_each_pipeline_span(micrographs, clean, monkeypatch, capsys):
    monkeypatch.setenv("TOPAZ_TIMINGS", "1")
    assert profiling.timing_enabled()
    pipe = MicrographPipeline(model="resnet8_u32", scale=2, radius=3, threshold=0.0,
                              num_workers=2, device="cpu")
    list(pipe.process(micrographs[:2], batch_size=BATCH))
    err = capsys.readouterr().err
    for name in ("pipeline/read", "pipeline/wait", "pipeline/upload", "pipeline/normalize",
                 "pipeline/score", "pipeline/fetch"):
        assert f"[timing] {name}: " in err, name
    assert "pipeline/batch" not in err


def test_a_profile_alone_does_not_time(monkeypatch):
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    monkeypatch.setenv("TOPAZ_PROFILE", "unused")
    assert not profiling.timing_enabled()


@pytest.mark.parametrize("command,span", [
    (["denoise", "-m", "unet-small", "-s", "0", "-d", "cpu"], "denoise/unet"),
    (["extract", "-m", "resnet8_u32", "-r", "3", "-t", "0", "--batch-size", "2", "-d", "cpu"],
     "pipeline/read"),
])
def test_a_cli_command_under_topaz_profile_writes_a_trace(micrographs, tmp_path, monkeypatch,
                                                          command, span):
    monkeypatch.setenv("TOPAZ_PROFILE", str(tmp_path / "trace"))
    monkeypatch.delenv("TOPAZ_TIMINGS", raising=False)
    main(command + ["-o", str(tmp_path / "out")] + micrographs[:2])
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    named = [e for e in events if e.get("name") == span and e.get("ph") == "X"]
    assert named, sorted({e.get("name") for e in events if e.get("cat") == "user_annotation"})
    if span == "pipeline/read":  # a loader thread's span, not the main thread's
        main_tid = threading.get_native_id()
        assert all(e["tid"] != main_tid for e in named)
    profiling.reset()
