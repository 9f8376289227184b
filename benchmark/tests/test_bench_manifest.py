"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import os
import re

import pytest

from benchmark.harness import manifest as mf

MAN = mf.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(mf.ROOT, "BENCHMARK.json")) < 65536
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    e2e_keys = {"name", "unit", "better", "bound", "source"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == e2e_keys
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = []
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in
                                             c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w, config, traffic = mf.load_cell(MAN, cell)
    assert config["name"] == w["config"]
    assert config["chips"] == w["chips"]
    entry = mf.load_module("entries", traffic["entry"])
    assert hasattr(entry, "Entry")
    cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert cfg["file"].startswith("benchmark/")
    assert config["reduced"] == cfg["reduced"]
    for m in mf.cell_metrics(MAN, cell, False) + mf.cell_metrics(
            MAN, cell, True):
        assert callable(mf.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in mf.cell_metrics(MAN, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mf.cell_metrics(MAN, cell, True)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)


def test_per_layer_moves_a_metric_of_its_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)

