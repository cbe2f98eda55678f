"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import os
import re

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_bm_keys_and_names():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = ([c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_bm_every_cell_finds_its_files():
    b = spec.load()
    per_layer = {m["name"] for m in b["per_layer"]}
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        assert cell.config["name"] == w["config"] and cell.config["reduced"] == []
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        module = cell.driver()
        assert all(callable(getattr(module, f)) for f in ("Driver", "check", "control"))
    assert per_layer <= {m["name"] for w in b["workloads"] for m in spec.Cell(b, w["name"]).per_layer}


@pytest.mark.parametrize("path_key", ["file"])
def test_bm_config_files_hold_the_run(path_key):
    b = spec.load()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c[path_key]))
        cfg = spec.Cell(b, next(w["name"] for w in b["workloads"] if w["config"] == c["name"])).config
        for key in ("picker", "path", "gmm", "limits"):
            assert key in cfg
        assert os.path.isfile(os.path.join(spec.ROOT, cfg["picker"]["weights"]))


def test_bm_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Cell(spec.load(), "no.such.cell")
