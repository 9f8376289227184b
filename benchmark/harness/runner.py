"""One run of one cell: set-up, the measured window, the check, the metrics.

The cell's traffic file names an entry (``entries/<entry>.py``), whose
``Entry`` makes the inputs from the seed, drives the program once a call
and judges what the calls returned. The runner owns the rest:

1. Set-up: the entry builds its inputs and the program's objects and warms
   every shape its calls use (``warm``); the peak memory counters are reset
   and ``setup_s`` ends at the first timed call.
2. The window: a closed loop of one caller, calls back to back until
   ``seconds`` have passed since the first began (the last call ends past
   it and counts whole). Each call's wall time is taken by the host clock
   around the public call, which returns host data. A sample of the calls,
   drawn from the seed, keeps its output for the check, with the last.
   With ``trace`` the window runs under ``torch.profiler`` with the spans
   of the entry's layers wrapped (``trace.Spans``).
3. After the window: the peak device memory is read, the program's state is
   freed and the entry compares the kept outputs with the reference. Each
   number compared is printed beside its limit.
4. The metrics the manifest gives the cell, each read by
   ``metrics/<name>.py`` from the run's record.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from . import manifest as mf
from . import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "seqoia_tpu")


class Record:
    """What a run leaves for the metric readers."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.calls: list = []      # per call: wall_s, units, counters, spans
        self.device_peak_bytes = 0
        self.trace: dict | None = None


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _program_defaults():
    """The program with its defaults: no SEQOIA_* setting from the caller's
    environment reaches it."""
    for k in [k for k in os.environ if k.startswith("SEQOIA_")]:
        del os.environ[k]


def _keep_plan(seed: int, max_keep: int):
    """Which calls keep their output: the first, then every ``every``-th
    from ``offset`` up to ``max_keep``; drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    every = int(rng.integers(5, 13))
    offset = int(rng.integers(1, every + 1))
    return lambda i, kept: kept < max_keep and (
        i == 0 or (i >= offset and (i - offset) % every == 0))


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float | None = None, devices=None, manifest=None,
        config=None, control: bool = False):
    """Run one cell (module docstring). ``devices``: the devices to run on
    (default: the cell's cards); ``manifest`` / ``config``: replacements
    of the committed ones (the tests' small sizes). Returns (result line
    dict, [(name, value, limit)])."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or mf.load_manifest()
    cell, cfg, traffic = mf.load_cell(manifest, cell_name)
    config = config or cfg
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    _program_defaults()
    # the deployment's process, as the traffic mix gives it (PERF.md)
    torch.set_num_threads(traffic["intra_op_threads"])
    rec = Record()
    entry = mf.load_module("entries", traffic["entry"]).Entry(
        config, traffic, seed, devices)
    entry.warm()
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    call = entry.control_call if control else entry.call
    keep = _keep_plan(seed, traffic.get("kept_calls", 4))
    kept, last = [], None
    attempted = failed = 0
    spans = tr.Spans(entry.span_targets() if trace else ())
    prof = tr.profiler() if trace and devices[0].type == "cuda" else None
    patches = entry.trace_patches() if trace else contextlib.nullcontext()
    with spans, patches:
        if prof is not None:
            prof.__enter__()
            call()  # the profiler's own first-call costs, outside the window
            _sync(devices)
            spans.take()
            entry.counters()
        rec.setup_s = time.perf_counter() - t_start
        with torch.profiler.record_function(tr.WINDOW):
            t0 = time.perf_counter()
            i = 0
            while True:
                tc = time.perf_counter()
                out = call()
                wall = time.perf_counter() - tc
                n_att, n_fail = entry.outcome(out)
                attempted += n_att
                failed += n_fail
                rec.calls.append({"wall_s": wall, "units": entry.units,
                                  "counters": entry.counters(),
                                  "spans": spans.take()})
                if keep(i, len(kept)):
                    kept.append(out)
                last = out
                del out
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            rec.window_s = time.perf_counter() - t0
        if prof is not None:
            _sync(devices)
            prof.__exit__(None, None, None)
    rec.device_peak_bytes = max(
        (torch.cuda.max_memory_allocated(d) for d in devices
         if d.type == "cuda"), default=0)
    if prof is not None:
        rec.trace = tr.summarize(prof, len(devices))
        del prof
    if last is not kept[-1]:
        kept.append(last)
    del last
    entry.close()
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    compared = entry.check(kept) + [("failed_results", failed, 0)]
    del kept
    correct = all(v <= lim for _, v, lim in compared)

    metrics = {}
    for m in mf.cell_metrics(manifest, cell_name, trace):
        value = mf.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev0 = devices[0]
    result = {
        "correct": correct, "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev0.type == "cuda" else dev0.type,
            "kind": (torch.cuda.get_device_name(dev0)
                     if dev0.type == "cuda" else "cpu"),
            "count": len(devices),
            "memory_peak_bytes": rec.device_peak_bytes,
        },
    }
    if rec.trace is not None:
        result["device"]["busy_s"] = sum(rec.trace["busy_s"]) / len(devices)
        result["device"]["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    # the calls' spread, and their medians in each tenth of the window:
    # a drift over the window shows there
    walls = [c["wall_s"] * 1e3 for c in rec.calls]
    tenths = [sorted(walls[len(walls) * k // 10: len(walls) * (k + 1) // 10]
                     or walls) for k in range(10)]
    ranked = sorted(walls)
    result["calls"] = len(walls)
    result["call_ms"] = {"min": ranked[0], "median": ranked[len(walls) // 2],
                         "max": ranked[-1],
                         "tenths": [t[len(t) // 2] for t in tenths]}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    return result, compared
