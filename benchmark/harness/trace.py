"""The traced run: spans of the benchmark's own around each model's forward,
``torch.profiler`` over the window, and the reduction of its Chrome trace
to device busy time, device time by span and by kernel, and idle gaps.

A kernel belongs to a span when the host call that launched it (matched by
the trace's correlation id) ran inside the span, on the same thread.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict
from typing import Dict

import torch

WINDOW = "bm/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class ModuleSpans:
    """``bm/<name>`` profiler spans around every forward of each module."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self._local = threading.local()
        self._handles = []
        for name, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(self._enter(name)))
            self._handles.append(module.register_forward_hook(self._exit()))

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _enter(self, name):
        def hook(module, args):
            span = torch.profiler.record_function(f"bm/{name}")
            span.__enter__()
            self._stack().append(span)
        return hook

    def _exit(self):
        def hook(module, args, output):
            self._stack().pop().__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self._handles:
            h.remove()


def profiler():
    """``torch.profiler`` over the host's ops on every thread (threads a
    program started before the window too) and the card's kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  experimental_config=config)


def _busy_intervals(intervals):
    """Merged, sorted busy intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(path: str, top: int = 10) -> dict:
    """Reduce a Chrome trace written by ``export_chrome_trace``: times in
    seconds, over the ``bm/window`` span (the traced window)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("trace: no bm/window span")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = defaultdict(list)  # tid -> [(start, end, name)]
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") != WINDOW:
            spans[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for v in spans.values():
        v.sort()
    launches = defaultdict(list)  # tid -> [(ts, correlation)]
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[e.get("tid")].append((float(e["ts"]), corr))
    # the spans open at each launch, in one sweep a thread (spans nest)
    open_at = {}
    for tid, calls in launches.items():
        todo, stack, i = spans.get(tid, []), [], 0
        for ts, corr in sorted(calls):
            while i < len(todo) and todo[i][0] <= ts:
                while stack and stack[-1][1] < todo[i][0]:
                    stack.pop()
                stack.append(todo[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            open_at[corr] = {name for _, _, name in stack}

    by_name = defaultdict(float)
    by_span = defaultdict(float)
    clipped = []
    for e in device:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if b <= w0 or a >= w1:
            continue
        clipped.append((max(a, w0), min(b, w1)))
        dur = (b - a) / 1e6
        by_name[e["name"]] += dur
        for name in open_at.get(e.get("args", {}).get("correlation"), ()):
            by_span[name] += dur
    merged = _busy_intervals(clipped)
    busy = sum(b - a for a, b in merged)
    gaps = []
    prev = w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    all_spans = sorted((s for v in spans.values() for s in v), key=lambda s: s[1] - s[0])

    def host_doing(ts):
        for a, b, name in all_spans:  # the innermost span open at ts
            if a <= ts <= b:
                return name
        return "no span"

    idle = [[host_doing((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "device_s_by_span": dict(by_span),
        "device_s_by_kernel": dict(by_name),
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": idle,
        },
    }


def export_and_reduce(prof, workdir: str) -> dict:
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return reduce(path)
    finally:
        os.remove(path)
