"""The readers of the program's spans: the device time of a span over the
answers of a reduced trace, and the loaders' reads and the queue's waits
of the window taken from the program's record of its stages (warm passes
left out, a ring too small for the window read as nothing)."""

from types import SimpleNamespace

import pytest

from harness import spec
from topaz_tpu_torch.utils import profiling

DEVICE = {"upload.device_ms.session": "pipeline/upload",
          "upload.device_ms.denoise": "denoise/upload",
          "fetch.device_ms.denoise": "denoise/fetch"}


def _run(completed, trace=None):
    return SimpleNamespace(driver=SimpleNamespace(completed=completed), trace=trace)


@pytest.fixture
def clock(monkeypatch):
    """A fake ``perf_counter_ns`` the test sets, and an empty record."""
    now = [0]
    monkeypatch.setattr(profiling, "_clock", lambda: now[0])
    profiling.reset()
    yield now
    profiling.reset()


def _span(clock, name, start, end):
    clock[0] = start
    with profiling.stage(name) as s:
        clock[0] = end
    return s


def _pass(clock, t, reads, read_ns, wait_ns):
    """One pass from ``t``: ``reads`` reads of ``read_ns`` each, then a
    wait of ``wait_ns`` a read and the final wait of 1 ns."""
    for i in range(reads):
        _span(clock, "pipeline/read", t + i, t + i + read_ns)
    t += reads + read_ns
    for _ in range(reads):
        _span(clock, "pipeline/wait", t, t + wait_ns)
        t += wait_ns
    _span(clock, "pipeline/wait", t, t + 1)
    return t + 10


@pytest.mark.parametrize("name", sorted(DEVICE))
def test_bm_device_span_readers_divide_by_the_answers(name):
    read = spec.reader(name)
    trace = {"device_s_by_span": {DEVICE[name]: 0.5, "bm/unet": 9.0}}
    assert read(_run(200, trace)) == pytest.approx(2.5)  # 500 ms over 200
    assert read(_run(200, None)) is None  # an untraced run
    assert read(_run(0, trace)) is None
    assert read(_run(10, {"device_s_by_span": {"bm/unet": 1.0}})) is None  # a parent's trace


def test_bm_the_window_reads_and_waits_leave_the_warm_passes_out(clock):
    t = _pass(clock, 0, reads=6, read_ns=5_000_000, wait_ns=9_000_000)       # warm
    t = _pass(clock, t, reads=6, read_ns=5_000_000, wait_ns=9_000_000)       # warm
    t = _pass(clock, t, reads=4, read_ns=2_000_000, wait_ns=3_000_000)       # window
    _pass(clock, t, reads=4, read_ns=4_000_000, wait_ns=1_000_000)           # window
    run = _run(8)
    assert spec.reader("loader.read_ms.session")(run) == pytest.approx(3.0)
    # waits 4 x 3 ms + 1 ns and 4 x 1 ms + 1 ns over 8 answers
    assert spec.reader("loader.wait_ms.session")(run) == pytest.approx((16e6 + 2) / 1e6 / 8)


def test_bm_a_window_larger_than_the_ring_reads_nothing(clock, monkeypatch):
    monkeypatch.setattr(profiling, "RING", 6)
    t = _pass(clock, 0, reads=4, read_ns=10, wait_ns=10)
    _pass(clock, t, reads=4, read_ns=10, wait_ns=10)
    # 8 reads in the window, 6 kept
    assert spec.reader("loader.read_ms.session")(_run(8)) is None
    assert spec.reader("loader.wait_ms.session")(_run(8)) is None
    # the last pass alone fits; its waits (5) do too
    assert spec.reader("loader.read_ms.session")(_run(4)) == pytest.approx(1e-5)
    assert spec.reader("loader.wait_ms.session")(_run(4)) == pytest.approx(41e-6 / 4)


def test_bm_the_wait_reader_sees_a_ring_that_lost_window_waits(clock, monkeypatch):
    monkeypatch.setattr(profiling, "RING", 3)
    for i in range(3):
        _span(clock, "pipeline/read", i, i + 5)
    for i in range(5):  # 5 waits in the window, 3 kept
        _span(clock, "pipeline/wait", 10 + i, 11 + i)
    assert spec.reader("loader.read_ms.session")(_run(3)) is not None
    assert spec.reader("loader.wait_ms.session")(_run(3)) is None


def test_bm_host_span_readers_read_nothing_without_samples(clock):
    for name in ("loader.read_ms.session", "loader.wait_ms.session"):
        assert spec.reader(name)(_run(5)) is None
        assert spec.reader(name)(_run(0)) is None
