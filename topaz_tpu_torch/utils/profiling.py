"""Stage spans and profiler traces (port of topaz_tpu/utils/profiling.py).

``stage(name)`` marks a block of work. While a profiler runs, each stage is
a ``torch.profiler.record_function`` span, on the thread that does the
work, so the trace shows it on the clock of the device's kernels (a kernel
belongs to the spans open at its launch). Each stage also leaves a
sample in memory: its name, thread, start and end on
``time.perf_counter_ns``, the stage that encloses it on the same thread,
and the batch it belongs to, where one applies. A name keeps an exact count
and total and its newest ``RING`` samples: ``timings()``, ``samples()`` and
``records()`` read them. With ``TOPAZ_TIMINGS`` set each stage prints its
time to stderr, and a stage given a ``device`` first waits for that
device's work, so the time includes the device's. ``TOPAZ_PROFILE=<dir>``
makes ``profile_session`` (around every CLI command) write a
``torch.profiler`` Chrome trace of the whole run, every thread's spans
included, into that directory; it does not synchronise.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler

# samples kept a name: a pipeline session records one read and one upload a
# micrograph, ~16 a second, so this holds over four minutes of them
RING = 4096

_clock = time.perf_counter_ns
_lock = threading.Lock()
# .top: a thread's innermost open stage; .tid: its native id (a system
# call to read, so read once)
_local = threading.local()


class Sample(NamedTuple):
    name: str
    thread: int            # native id: the thread's tid in a profiler trace
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the enclosing stage on the same thread
    batch: Optional[int]   # the batch's number within one pipeline call


class _Record:
    __slots__ = ("count", "total_ns", "ring")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.ring: collections.deque = collections.deque(maxlen=RING)


_records: Dict[str, _Record] = {}


class stage:
    """Time a block of work, inside a profiler span of the same name.

    ``batch`` is the batch the work belongs to (settable on the span inside
    the block, where it is known only there); ``device`` the CUDA device
    whose work the block launches, waited for at the end under
    ``TOPAZ_TIMINGS`` only."""

    __slots__ = ("name", "batch", "device", "_span", "_parent", "_t0")

    def __init__(self, name: str, batch: Optional[int] = None, device=None):
        self.name, self.batch, self.device = name, batch, device

    def __enter__(self) -> "stage":
        self._parent = getattr(_local, "top", None)
        _local.top = self.name
        # a profiler span only while a profiler runs (torch's own flag, set
        # for every thread): with none, entering one costs more than all the
        # rest of the stage
        self._span = None
        if getattr(_torch_profiler, "_is_profiler_enabled", True):
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        timed = timing_enabled()
        if timed and exc_type is None and self.device is not None \
                and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = _clock()
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        _local.top = self._parent
        tid = getattr(_local, "tid", None)
        if tid is None:
            tid = _local.tid = threading.get_native_id()
        sample = (self.name, tid, self._t0, t1, self._parent, self.batch)
        with _lock:
            rec = _records.get(self.name)
            if rec is None:
                rec = _records[self.name] = _Record()
            rec.count += 1
            rec.total_ns += t1 - self._t0
            rec.ring.append(sample)
        if timed:
            print(f"# [timing] {self.name}: {(t1 - self._t0) / 1e6:.1f} ms", file=sys.stderr)


def timing_enabled() -> bool:
    """True when per-stage times are printed (``TOPAZ_TIMINGS``)."""
    return bool(os.environ.get("TOPAZ_TIMINGS"))


@contextlib.contextmanager
def profile_session() -> Iterator[None]:
    """Trace a whole run with ``torch.profiler`` when ``TOPAZ_PROFILE`` is
    set, every thread's spans included, and write the Chrome trace into
    that directory."""
    trace_dir = os.environ.get("TOPAZ_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    with profile(activities=activities, experimental_config=config) as prof:
        yield
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}", file=sys.stderr)


def timings() -> Dict[str, Dict[str, float]]:
    """Every stage's exact count, total seconds and mean milliseconds."""
    with _lock:
        totals = [(name, rec.count, rec.total_ns) for name, rec in _records.items()]
    return {name: {"count": n, "total_s": ns / 1e9, "mean_ms": ns / 1e6 / n}
            for name, n, ns in totals}


def records(name: str) -> List[Sample]:
    """The newest (at most ``RING``) samples of stage ``name``, oldest
    first."""
    with _lock:
        rec = _records.get(name)
        kept = list(rec.ring) if rec is not None else []
    return [Sample._make(s) for s in kept]


def count(name: str) -> int:
    """How many times stage ``name`` has ended, the ring's lost ones too."""
    with _lock:
        rec = _records.get(name)
        return rec.count if rec is not None else 0


def samples(name: str) -> list:
    """The newest recorded times of stage ``name``, in seconds, in order."""
    return [(s.end_ns - s.start_ns) / 1e9 for s in records(name)]


def reset() -> None:
    with _lock:
        _records.clear()
