"""The cell ``cifar10.sqoa_decode`` on the CPU at its own 32x32 size, with 16
images in place of 512: every one of its streams takes the icon-class
packed route (``small.small_config`` turns photos into 160x120, which takes
the regular route). A sound run is correct and packs its streams; the
control, and one byte altered in a packed image's result, are not correct;
the cell's two readers read the program's ``parallel.classify`` span and
``parallel.packed.images`` counter from a traced record, and None where the
record lacks them or the program has no tracer."""

import copy
import functools

import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness import runner

CELL = "cifar10.sqoa_decode"
ROOT = "api.batch_decode"
N = 16          # images a call here; 8 to a packed row at bucket 4096
METRICS = {"parallel.classify_ms.decode": "parallel.classify",
           "parallel.packed_images.decode": "parallel.packed.images"}


def _config():
    """The committed configuration with ``N`` images."""
    _, cfg, _ = mf.load_cell(mf.load_manifest(), CELL)
    cfg = copy.deepcopy(cfg)
    (im,) = cfg["images"]
    assert (im["width"], im["height"], im["count"]) == (32, 32, 512)
    im["count"] = N
    return cfg


def _run(trace=False, control=False, seed=2**31 + 4242):
    return runner.run(CELL, seed, 0.2, trace,
                      devices=[torch.device("cpu")], config=_config(),
                      control=control)


def _stats(monkeypatch):
    """Every BatchDecoder call's ``last_stats``, as the calls return."""
    from seqoia_tpu_torch.parallel import batch

    seen = []
    fn = batch.BatchDecoder.__call__

    @functools.wraps(fn)
    def call(self, *a, **k):
        out = fn(self, *a, **k)
        seen.append(dict(self.last_stats))
        return out

    monkeypatch.setattr(batch.BatchDecoder, "__call__", call)
    return seen


def test_cell_is_in_the_manifest():
    man = mf.load_manifest()
    traced = {m["name"] for m in mf.cell_metrics(man, CELL, True)}
    assert set(METRICS) <= traced
    assert {m["name"] for m in mf.cell_metrics(man, CELL, False)} == {
        "decode_mpx_s", "device_peak_gib", "setup_s"}


def test_sound_run_is_correct_and_packed(monkeypatch):
    seen = _stats(monkeypatch)
    res, compared = _run()
    assert res["correct"], compared
    assert res["attempted"] == N * res["calls"] and res["failed"] == 0
    assert all(v == 0 for _, v, _ in compared)
    assert seen and all(s["packed_rows"] == N // 8 and s["host_rows"] == 0
                        for s in seen)


def test_control_is_not_correct():
    res, compared = _run(control=True)
    assert not res["correct"]
    assert max(v for _, v, lim in compared if v > lim) > 100


def test_altered_packed_byte_is_caught(monkeypatch):
    from seqoia_tpu_torch.parallel import batch

    fn = batch.BatchDecoder._finish
    altered = []

    @functools.wraps(fn)
    def finish(self, entry, results, fallback):
        fn(self, entry, results, fallback)
        assert entry.seg_k is not None  # a packed class
        px = results[entry.items[-1][0]].pixels
        px[px.size // 3] ^= 0x10
        altered.append(entry.items[-1][0])

    monkeypatch.setattr(batch.BatchDecoder, "_finish", finish)
    res, compared = _run()
    assert altered and not res["correct"]
    assert dict((n, v) for n, v, _ in compared)["wrong_pixel_bytes"] > 0


@pytest.fixture(scope="module")
def traced():
    """The result line of one traced run with the program's tracer on, and
    its window's root calls."""
    from seqoia_tpu_torch.utils import trace

    trace.enable()
    try:
        res, _ = _run(trace=True)
        calls = trace.calls(res["calls"])
    finally:
        trace.disable()
    return res, calls


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_reads_a_traced_run(traced, metric):
    res, calls = traced
    assert res["correct"]
    value = res["metrics"][metric]["value"]
    assert all(c["name"] == ROOT for c in calls)
    if metric == "parallel.packed_images.decode":
        assert value == N
        assert all(c["counters"]["parallel.packed.rows"] == N // 8
                   for c in calls)
    else:
        assert value > 0
        for c in calls:
            (span,) = [s for s in c["spans"] if s["name"] == METRICS[metric]]
            assert span["attrs"] == {"images": N, "classes": 1}
            assert span["parent"] == c["spans"][0]["id"]


def _packed_call():
    """One BatchDecoder call of ``N`` of the cell's images with the
    program's tracer on."""
    from benchmark.reference import codec, corpus
    from seqoia_tpu_torch.parallel import batch
    from seqoia_tpu_torch.utils import trace

    streams = [codec.encode(img, 32, 32, 3).numpy().tobytes() for _, img in
               corpus.make_images(_config()["images"], 7, "cpu")]
    trace.enable()
    try:
        batch.BatchDecoder(device="cpu")(streams)
    finally:
        trace.disable()


def _window_of_last(n):
    rec = runner.Record()
    rec.calls = [{"wall_s": 1e3}] * n
    return rec


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_is_none_without_its_span_or_counter(metric):
    """A root call that opens neither (as the program did before they were
    added): None; one regular-route call: the span but no packed image."""
    import numpy as np

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", metric)
    trace.enable()
    try:
        with trace.entry(ROOT):
            pass
        assert reader.read(_window_of_last(1)) is None
        px = np.arange(16 * 8 * 3, dtype=np.uint8)
        stream = st.encode(px, st.SqoaDesc(16, 8, 3, 0, 0), backend="native")
        st.BatchDecoder(device="cpu")([stream])
    finally:
        trace.disable()
    value = reader.read(_window_of_last(1))
    if metric == "parallel.packed_images.decode":
        assert value is None
    else:
        assert value > 0


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_is_none_with_spans_off(traced, metric):
    """A traced CPU run starts no profiler: with the tracer not enabled the
    window's calls are not recorded."""
    res, _ = _run(trace=True)
    assert res["correct"] and metric not in res["metrics"]


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_is_none_without_the_programs_tracer(metric, monkeypatch):
    import sys

    import seqoia_tpu_torch.utils as utils

    _packed_call()
    rec = _window_of_last(1)
    assert mf.load_module("metrics", metric).read(rec) is not None
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "seqoia_tpu_torch.utils.trace", None)
    assert mf.load_module("metrics", metric).read(rec) is None
