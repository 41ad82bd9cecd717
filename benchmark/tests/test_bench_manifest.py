"""BENCHMARK.json against the contract's form, and every name it uses
found as a file of its own."""

import importlib
import json
import os
import re

import pytest

from benchmark.harness import core

M = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"] and M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_entry_keys():
    seen = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        assert m["better"] in ("lower", "higher")
        seen.add(m["name"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = core.find_cell(cell)
    assert c.traffic["entry"]
    importlib.import_module(f"benchmark.drivers.{c.traffic['entry']}")
    assert c.limits["limits"]
    conf = [x for x in M["configs"] if x["name"] == cell.split(".")[0]][0]
    assert json.load(open(os.path.join(core.ROOT, conf["file"])))["reduced"] == conf["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    c = core.find_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_reader_and_moves(metric):
    m = [x for x in M["per_layer"] if x["name"] == metric][0]
    reader = importlib.import_module(f"benchmark.metrics.{metric.partition('.')[0]}")
    assert callable(reader.read)
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in core.find_cell(cell).end_to_end}
    if metric.endswith("_roofline") or "_roofline." in metric or "mfu" in metric:
        assert m["unit"] == "%"


def test_run_seconds_fit_the_check_budget():
    full = 24
    runs = 2 + 14 * full
    assert runs * (M["run_seconds"] + 60) + full * 2 * 90 + 1200 <= 43200


def test_layers_named_alike():
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["name"].partition(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
