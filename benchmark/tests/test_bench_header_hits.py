"""The reader of the program's ``parallel.classify.header_hits`` counter
(``metrics/parallel.header_hits.decode.py``), on small CPU runs with the
program's tracer turned on by the test: it reads the counter's delta, mean
a call, in a traced run of each of its cells; it returns None where no call
of the window counted it (a program without the counter, or calls that hit
no header twice), where spans were off, and where the window is not a run
of ``api.batch_decode`` calls the tracer recorded whole."""

import numpy as np
import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import runner
from benchmark.tests.small import run_small

METRIC = "parallel.header_hits.decode"
ROOT = "api.batch_decode"
COUNTER = "parallel.classify.header_hits"
CELLS = ("cifar10.sqoa_decode", "kodak24.sqoa_decode")


def _small(cell, trace=False):
    """One run of the cell on the CPU at a small size: ``small.run_small``,
    but the cifar10 cell keeps its 32x32 images, 16 of them."""
    if cell != "cifar10.sqoa_decode":
        return run_small(cell, trace=trace)
    import copy

    import torch

    _, cfg, _ = mf.load_cell(mf.load_manifest(), cell)
    cfg = copy.deepcopy(cfg)
    cfg["images"][0]["count"] = 16
    return runner.run(cell, 2**31 + 99, 0.2, trace,
                      devices=[torch.device("cpu")], config=cfg)


@pytest.fixture(scope="module")
def traced():
    """{cell: (result line, the window's root calls)} of one traced small
    run a cell with the tracer on."""
    from seqoia_tpu_torch.utils import trace

    out = {}
    trace.enable()
    try:
        for cell in CELLS:
            res, _ = _small(cell, trace=True)
            out[cell] = (res, trace.calls(res["calls"]))
    finally:
        trace.disable()
    return out


def _window(n, wall_s=1e3):
    rec = runner.Record()
    rec.calls = [{"wall_s": wall_s}] * n
    return rec


def _stream(width=16, height=8):
    import seqoia_tpu_torch as st

    px = np.arange(width * height * 3, dtype=np.uint8)
    return st.encode(px, st.SqoaDesc(width, height, 3, 0, 0),
                     backend="native")


def _calls(*batches):
    """One decoder's calls of ``batches`` with the tracer on."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    trace.enable()
    try:
        dec = st.BatchDecoder(device="cpu")
        for streams in batches:
            dec(streams)
    finally:
        trace.disable()


@pytest.mark.parametrize("cell", CELLS)
def test_reader_is_in_the_manifest(cell):
    man = mf.load_manifest()
    assert METRIC in {m["name"] for m in mf.cell_metrics(man, cell, True)}
    assert METRIC not in {m["name"]
                          for m in mf.cell_metrics(man, cell, False)}


@pytest.mark.parametrize("cell", CELLS)
def test_reader_reads_a_traced_run(traced, cell):
    """Every call of the small cells holds images of one header: each
    call's hits are its images less one."""
    res, calls = traced[cell]
    assert res["correct"]
    assert calls and all(c["name"] == ROOT for c in calls)
    images = res["attempted"] // res["calls"]
    assert images > 1
    assert all(c["counters"][COUNTER] == images - 1 for c in calls)
    assert res["metrics"][METRIC]["value"] == images - 1


@pytest.mark.parametrize("cell", CELLS)
def test_reader_returns_none_with_spans_off(traced, cell):
    """A traced CPU run starts no profiler: with the tracer not enabled the
    window's calls are not recorded."""
    res, _ = _small(cell, trace=True)
    assert res["correct"]
    assert METRIC not in res["metrics"]


def test_reader_is_none_without_the_counter():
    """A root call that reads no header, as a program before the counter
    opens its calls, and a call of one stream, which hits nothing: None."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    trace.enable()
    try:
        with trace.entry(ROOT):
            pass
    finally:
        trace.disable()
    assert reader.read(_window(1)) is None
    _calls([_stream()])
    assert COUNTER not in trace.calls(1)[0]["counters"]
    assert reader.read(_window(1)) is None


def test_reader_is_the_mean_a_call():
    """Calls of 3, 5 and 1 copies of a stream and of two headers twice:
    2, 4, 0 and 2 hits. Windows of the last 1, 2, 3 and 4 calls."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    s, t = _stream(), _stream(8, 4)
    _calls([s] * 3, [s] * 5, [s], [s, t, t, s])
    assert [c["counters"].get(COUNTER, 0) for c in trace.calls(4)] == \
        [2, 4, 0, 2]
    assert reader.read(_window(1)) == 2.0
    assert reader.read(_window(2)) == 1.0
    assert reader.read(_window(3)) == 2.0
    assert reader.read(_window(4)) == 2.0


def test_reader_is_none_outside_a_window_of_batch_decodes():
    """A window whose calls include another entry point's, one longer than
    the tracer's record, or one whose call outlasted the window's: None."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    s = _stream()
    _calls([s] * 3)
    assert reader.read(_window(1)) == 2.0
    assert reader.read(_window(1, wall_s=0.0)) is None
    assert reader.read(_window(len(trace.calls()) + 1)) is None
    trace.enable()
    try:
        st.encode_large(np.arange(16 * 8 * 3, dtype=np.uint8),
                        st.SqoaDesc(16, 8, 3, 0, 0), device="cpu")
    finally:
        trace.disable()
    assert trace.calls(1)[0]["name"] == "api.encode_large"
    assert reader.read(_window(1)) is None
    assert reader.read(_window(2)) is None
