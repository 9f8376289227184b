"""The whole run on the CPU, the look for a card skipped, at a small size:
sound, it comes out correct; with the timed path broken underneath, or with
the control in the program's place, it comes out not correct."""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.tests.small import CELLS, run_small


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, compared = run_small(cell)
    assert res["correct"], compared
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {
        m["name"] for m in mf.cell_metrics(mf.load_manifest(), cell, False)
        if m["name"] != "device_peak_gib"}  # no card: no device memory
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_host_metrics(cell):
    res, _ = run_small(cell, trace=True)
    assert res["correct"]
    want = {"parallel.host_ms.decode", "codec.compat_passes",
            "parallel.host_ms.encode", "parallel.call_p95_ms.decode",
            "parallel.call_mpx_s.encode"}
    names = {m["name"] for m in mf.cell_metrics(mf.load_manifest(), cell,
                                                True)}
    assert set(res["metrics"]) == names & want
    for v in res["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res, compared = run_small(cell, control=True)
    assert not res["correct"]
    assert max(v for _, v, lim in compared if v > lim) > 100


def _patch(monkeypatch, owner, attr, make):
    fn = getattr(owner, attr)
    monkeypatch.setattr(owner, attr, functools.wraps(fn)(make(fn)))


def _unchanged(monkeypatch):
    """Every decode and encode step returns its output buffer as it was
    allocated (zeros), its state unchanged."""
    from seqoia_tpu_torch.codec import decode_compat, decode_v2, encode_v2

    def zeroed(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            out[0].zero_()
            return out
        return f
    for owner, attr in [(decode_v2, "decode_stream_batched"),
                        (decode_v2, "decode_stream_packed"),
                        (decode_compat, "decode_stream_compat_batched"),
                        (encode_v2, "encode_stream_flat")]:
        _patch(monkeypatch, owner, attr, zeroed)


def _half_left_out(monkeypatch):
    """Half of each call's work left out: the second half of the streams
    never decoded, the second half of an image never encoded."""
    from seqoia_tpu_torch.ops import pack
    from seqoia_tpu_torch.parallel import batch

    def half_batch(fn):
        def f(self, streams, channels=0):
            k = len(streams) // 2
            return fn(self, streams[:k], channels) + [None] * (
                len(streams) - k)
        return f

    def half_image(fn):
        def f(pixels, desc, device="cuda"):
            px = np.array(pixels, np.uint8).reshape(-1)
            px[px.size // 2:] = 0
            return fn(px, desc, device=device)
        return f
    _patch(monkeypatch, batch.BatchDecoder, "__call__", half_batch)
    _patch(monkeypatch, pack, "normalize_pixels_device", half_image)


def _no_exchange(monkeypatch):
    """The split over the mesh keeps the first entry's share only."""
    from seqoia_tpu_torch.parallel import batch

    _patch(monkeypatch, batch, "batch_sharding",
           lambda fn: lambda mesh, n: fn(mesh, n)[:1])


def _altered(monkeypatch):
    """One byte of an answer altered where it is produced."""
    from seqoia_tpu_torch.parallel import batch, tiled

    def finish(fn):
        def f(self, entry, results, fallback):
            fn(self, entry, results, fallback)
            i = entry.items[0][0]
            px = results[i].pixels
            px[px.size // 2] ^= 1
        return f

    def file_bytes(fn):
        def f(desc, body):
            body = np.array(body)
            body[body.size // 2] ^= 1
            return fn(desc, body)
        return f
    _patch(monkeypatch, batch.BatchDecoder, "_finish", finish)
    _patch(monkeypatch, tiled, "_file_bytes", file_bytes)


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res, compared = run_small(cell)
    assert not res["correct"], compared


def test_mesh_without_exchange_is_not_correct(monkeypatch):
    """A configuration with ``mesh`` (none is committed yet: PERF.md's open
    questions) over four CPU entries."""
    from benchmark.harness import runner
    from benchmark.tests.small import small_config

    cfg = dict(small_config("kodak24.sqoa_decode"), mesh=True, chips=4)

    def run():
        return runner.run("kodak24.sqoa_decode", 2**31 + 77, 0.2, False,
                          devices=[torch.device("cpu")] * 4, config=cfg)
    res, compared = run()
    assert res["correct"], compared
    _no_exchange(monkeypatch)
    res, compared = run()
    assert not res["correct"], compared


def _run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "kodak24.sqoa_decode", "--seed", "5", "--seconds", "1", *args],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    out = _run_py(mf.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(mf.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(mf.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    """The control at the cell's own size, a short window: not correct."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "11", "--seconds", "2", "--control", "1"], cwd=mf.ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is False
