"""One run of one cell: set-up, the measured window, the peak memory, the
check against the reference, and the metrics the cell's readers find.

The cell's driver module (``benchmark/drivers/<driver>.py``) has a class
``Driver(config, traffic, seed, device, workdir)`` with ``setup()``,
``modules()`` (the models to span), ``window(seconds)`` (returns the
window's seconds), ``free()`` and the counts ``attempted`` and
``completed``; and the functions ``check(driver, reference)``, which
returns the numbers compared and the facts the reference worked out (for
the metric readers), and ``control(reference, traffic, seed, device,
workdir)``, the control's readings on the cell's inputs.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

import torch

from harness import check, spec, trace as tracing

# top-level module names the measured process may not hold (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "topaz_tpu")


class Run:
    """What a metric reader reads: the driver after its window (counts,
    answers, pixels), the window's host seconds, set-up
    seconds, the reduced trace of a traced run (else None), the facts the
    reference worked out in the check (such as its EM evaluations a file),
    and the cell's configuration and traffic."""

    def __init__(self, cell: spec.Cell, driver, setup_s: float, window_s: float,
                 trace: Optional[dict], facts: Dict[str, dict]):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.driver, self.setup_s, self.window_s = driver, setup_s, window_s
        self.trace, self.facts = trace, facts


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", root: str = spec.ROOT) -> Tuple[dict, Dict[str, dict]]:
    """Run ``cell`` once; returns (result line, the numbers compared with
    their limits)."""
    cuda = torch.device(device).type == "cuda"
    workdir = tempfile.mkdtemp(prefix="bm-")
    try:
        module = cell.driver()
        driver = module.Driver(cell.config, cell.traffic, seed, device, workdir)
        driver.setup()
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        reduced = None
        if trace:
            spans = tracing.ModuleSpans(driver.modules())
            with tracing.profiler() as prof:
                with torch.profiler.record_function(tracing.WINDOW):
                    window_s = driver.window(seconds)
                    _sync(device)
            spans.remove()
            reduced = tracing.export_and_reduce(prof, workdir)
        else:
            window_s = driver.window(seconds)
            _sync(device)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"forbidden modules loaded by the measured process: {bad}")
        driver.free()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        readings, facts = module.check(driver, check.Reference(cell.config, root, device))
        limits = cell.config["limits"]
        compared = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}

        run = Run(cell, driver, setup_s, window_s, reduced, facts)
        metrics = {}
        for m in cell.metrics(trace):
            value = spec.reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        if reduced is not None:
            dev["busy_s"] = reduced["busy_s"]
            dev["window_s"] = reduced["window_s"]
        result = {"correct": all(c["value"] <= c["limit"] for c in compared.values()),
                  "attempted": driver.attempted, "failed": driver.attempted - driver.completed,
                  "metrics": metrics, "device": dev}
        if reduced is not None:
            result["breakdown"] = reduced["breakdown"]
        result["compared"] = compared
        return result, compared
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
