"""Reading ``BENCHMARK.json`` and the files it names.

Everything of one configuration, traffic mix, entry or metric sits in a
file of its own, found by name: ``configs/<config>.json`` (the path the
manifest gives), ``traffic/<traffic>.json``, ``entries/<entry>.py`` (named
by the traffic file) and ``metrics/<metric>.py``. Adding a cell adds files
and manifest entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(manifest: dict, name: str):
    """(workload entry, configuration, traffic mix) of cell ``name``."""
    cell = _by_name(manifest["workloads"], name, "workload")
    cfg_entry = _by_name(manifest["configs"], cell["config"], "config")
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An end-to-end metric without
    ``workloads`` is every cell's; a per-layer one without it is every cell's
    that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and (m.get("workloads") or m["moves"] in mine)]


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (names
    may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
