"""Arithmetic that the metric readers share."""

from __future__ import annotations

from reference import counts


def idle_share(run):
    """1 - the device's busy time over the traced window."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]


def span_ms_per_answer(run, span: str):
    """Device milliseconds of the kernels launched inside ``bm/<span>``, a
    completed answer."""
    if run.trace is None or run.driver.completed == 0:
        return None
    s = run.trace["device_s_by_span"].get(f"bm/{span}")
    return None if not s else 1e3 * s / run.driver.completed


def kernel_s(run, fragment: str):
    """Device seconds of the kernels whose name holds ``fragment``."""
    if run.trace is None:
        return 0.0
    return sum(s for name, s in run.trace["device_s_by_kernel"].items() if fragment in name)


def valid_pixels(run) -> int:
    """Scored (valid, downsampled) pixels of every micrograph answered."""
    scale = run.config["path"]["scale"]
    shapes = {c["name"]: c["shape"] for c in run.traffic["cameras"]}
    total = 0
    for path, *_ in run.driver.answers:
        name = path.rsplit("/", 1)[-1].rsplit("_", 1)[0]
        h, w = shapes[name]
        total += int(h / scale) * int(w / scale)
    return total


def mfu_percent(flops: float, seconds: float):
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / counts.H100_F32_FLOPS
