"""Stage timings and profiler traces (port of topaz_tpu/utils/profiling.py).

``stage(name)`` records the wall time of a block, retrievable through
``timings()``, and prints it to stderr when ``TOPAZ_TIMINGS`` is set. Each
stage is also a ``torch.profiler.record_function`` span, so a profiler
trace shows the stages over the device's kernels. ``TOPAZ_PROFILE=<dir>``
makes ``profile_session`` write a ``torch.profiler`` Chrome trace of the
whole run into that directory.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_timings: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a pipeline stage, inside a profiler span of the same name."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _timings[name].append(dt)
    if os.environ.get("TOPAZ_TIMINGS"):
        print(f"# [timing] {name}: {dt * 1e3:.1f} ms", file=sys.stderr)


def timing_enabled() -> bool:
    """True when per-stage numbers are being reported or traced."""
    return bool(os.environ.get("TOPAZ_TIMINGS")
                or os.environ.get("TOPAZ_PROFILE"))


def sync_for_timing(outputs) -> None:
    """Wait for the device work behind ``outputs`` when timing is on.

    Kernels launch asynchronously, so a ``stage()`` block that only
    launches work measures the host's launches. Called on the outputs
    inside the stage block, this synchronises every CUDA device they lie on
    when ``TOPAZ_TIMINGS`` or ``TOPAZ_PROFILE`` is set, so the stage's time
    includes the device's; otherwise it does nothing and keeps the overlap
    of host and device."""
    if not timing_enabled():
        return
    devices = {t.device for t in _tensors(outputs) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _tensors(item)


@contextlib.contextmanager
def profile_session() -> Iterator[None]:
    """Trace a whole run with ``torch.profiler`` when ``TOPAZ_PROFILE`` is
    set, and write the Chrome trace into that directory."""
    trace_dir = os.environ.get("TOPAZ_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)
    print(f"# profiler trace written to {path}", file=sys.stderr)


def timings() -> Dict[str, Dict[str, float]]:
    return {
        name: {"count": len(ts), "total_s": sum(ts),
               "mean_ms": 1e3 * sum(ts) / len(ts)}
        for name, ts in _timings.items()
    }


def samples(name: str) -> list:
    """Every recorded time of stage ``name``, in seconds, in order."""
    return list(_timings.get(name, []))


def reset() -> None:
    _timings.clear()
