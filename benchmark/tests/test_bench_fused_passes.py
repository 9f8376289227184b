"""The reader of the program's ``codec.fixpoint.fused`` counter
(``metrics/codec.fused_passes.decode.py``), on small CPU runs with the
program's tracer turned on by the test: it reads the counter's delta, mean
a call, and equals ``codec.compat_passes`` when every pass runs fused; it
returns None where no call of the window counted it (the CPU path, whose
passes are library ops, and a program without the counter), where spans
were off, and where the window is not a run of ``api.batch_decode`` calls
the tracer recorded whole."""

import numpy as np

from benchmark.harness import manifest as mf
from benchmark.tests.small import run_small

METRIC = "codec.fused_passes.decode"
ROOT = "api.batch_decode"
COUNTER = "codec.fixpoint.fused"
CELL = "kodak24.qoi_decode"


def _window(n, wall_s=1e3):
    from benchmark.harness import runner

    rec = runner.Record()
    rec.calls = [{"wall_s": wall_s}] * n
    return rec


def _traced(fused):
    """One traced small run of the cell with the tracer on; with ``fused``
    every pass takes the card's route, whose kernels run their plain
    versions on the CPU."""
    from seqoia_tpu_torch.codec import decode_compat
    from seqoia_tpu_torch.utils import trace

    rows = decode_compat._Rows

    class Fused(rows):
        def __init__(self, *a):
            super().__init__(*a)
            self.ops = None

    trace.enable()
    try:
        if fused:
            decode_compat._Rows = Fused
        res, _ = run_small(CELL, trace=True)
        return res, trace.calls(res["calls"])
    finally:
        decode_compat._Rows = rows
        trace.disable()


def test_reader_is_in_the_manifest():
    man = mf.load_manifest()
    assert METRIC in {m["name"] for m in mf.cell_metrics(man, CELL, True)}
    assert METRIC not in {m["name"] for m in mf.cell_metrics(man, CELL, False)}
    for cell in mf.load_manifest()["workloads"]:
        if cell["name"] != CELL:
            assert METRIC not in {m["name"] for m in mf.cell_metrics(
                man, cell["name"], True)}


def test_reader_equals_the_passes_when_every_pass_is_fused():
    res, calls = _traced(fused=True)
    assert res["correct"]
    assert calls and all(c["name"] == ROOT for c in calls)
    assert all(c["counters"][COUNTER] > 0 for c in calls)
    assert res["metrics"][METRIC]["value"] == \
        res["metrics"]["codec.compat_passes"]["value"]


def test_reader_returns_none_on_the_library_route():
    """On the CPU the passes are library ops: no call counts a fused
    pass."""
    res, calls = _traced(fused=False)
    assert res["correct"] and calls
    assert all(COUNTER not in c["counters"] for c in calls)
    assert METRIC not in res["metrics"]


def test_reader_returns_none_with_spans_off():
    res, _ = run_small(CELL, trace=True)
    assert res["correct"]
    assert METRIC not in res["metrics"]


def test_reader_is_the_mean_a_call():
    """Calls that count 15, 3 and 0 fused passes: windows of the last 1, 2
    and 3 calls; a window of calls that counted none reads None."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    trace.enable()
    try:
        for n in (15, 3, 0):
            with trace.entry(ROOT):
                if n:
                    trace.count(COUNTER, n)
        assert reader.read(_window(1)) is None
        assert reader.read(_window(2)) == 1.5
        assert reader.read(_window(3)) == 6.0
    finally:
        trace.disable()


def test_reader_is_none_outside_a_window_of_batch_decodes():
    """A window whose calls include another entry point's, one longer than
    the tracer's record, or one whose call outlasted the window's: None."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    trace.enable()
    try:
        with trace.entry(ROOT):
            trace.count(COUNTER, 4)
        assert reader.read(_window(1)) == 4.0
        assert reader.read(_window(1, wall_s=0.0)) is None
        assert reader.read(_window(len(trace.calls()) + 1)) is None
        st.encode_large(np.arange(16 * 8 * 3, dtype=np.uint8),
                        st.SqoaDesc(16, 8, 3, 0, 0), device="cpu")
    finally:
        trace.disable()
    assert trace.calls(1)[0]["name"] == "api.encode_large"
    assert reader.read(_window(1)) is None
    assert reader.read(_window(2)) is None

