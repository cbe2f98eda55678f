"""``BENCHMARK.json`` and the files it names.

A cell's configuration is the file its ``configs`` entry gives, its
traffic ``benchmark/traffic/<traffic>.json``, the driver that the traffic's
``driver`` key names ``benchmark/drivers/<driver>.py``, and each of its
metrics a reader ``benchmark/metrics/<metric>.py`` with a function
``read(run)`` that returns a number, or None where the run has nothing for
it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.root = root
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _load_json(os.path.join(root, configs[self.entry["config"]]["file"]))
        self.traffic = _load_json(os.path.join(root, "benchmark", "traffic",
                                               self.entry["traffic"] + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"] if _covers(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"] if _covers(m, name)
                          and ("workloads" in m or m["moves"] in reported)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end

    def driver(self):
        """The module of the cell's driver."""
        return driver(self.traffic["driver"], self.root)


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(kind: str, name: str, root: str):
    path = os.path.join(root, "benchmark", kind, name + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"bm_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def load(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def driver(name: str, root: str = ROOT):
    """``benchmark/drivers/<name>.py``: its ``Driver`` class, ``check`` and
    ``control``."""
    return _load_module("drivers", name, root)


def reader(name: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    return _load_module("metrics", name, root).read
