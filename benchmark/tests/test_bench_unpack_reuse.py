"""The reader of the program's ``parallel.unpack.reuse`` counter
(``metrics/parallel.unpack_reuse.decode.py``), on small CPU runs with the
program's tracer turned on by the test, as ``test_bench_program_spans.py``
holds the other readers of the program's spans and counters: it reads its
value in a traced run, its counter occurs in a traced call of the batch
decode, it returns None where the window's calls were not all recorded, and
its value is the mean a call."""

import inspect

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import runner
from benchmark.tests.small import run_small
from benchmark.tests.test_bench_program_spans import _one_call

METRIC = "parallel.unpack_reuse.decode"
ROOT = "api.batch_decode"
COUNTER = "parallel.unpack.reuse"
CELLS = ("kodak24.sqoa_decode", "kodak24.qoi_decode")


@pytest.fixture(scope="module")
def traced():
    """{cell: (result line, the window's root calls)} of one traced small
    run a cell with the tracer on."""
    from seqoia_tpu_torch.utils import trace

    out = {}
    trace.enable()
    try:
        for cell in CELLS:
            res, _ = run_small(cell, trace=True)
            out[cell] = (res, trace.calls(res["calls"]))
    finally:
        trace.disable()
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_reader_is_in_the_manifest(cell):
    man = mf.load_manifest()
    assert METRIC in {m["name"] for m in mf.cell_metrics(man, cell, True)}


@pytest.mark.parametrize("cell", CELLS)
def test_reader_reads_a_traced_run(traced, cell):
    res, _ = traced[cell]
    assert res["correct"]
    assert res["metrics"][METRIC]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_counter_occurs_in_the_entry(traced, cell):
    calls = traced[cell][1]
    src = inspect.getsource(mf.load_module("metrics", METRIC))
    assert f'"{ROOT}"' in src and f'"{COUNTER}"' in src
    assert calls and all(c["name"] == ROOT for c in calls)
    assert any(COUNTER in c["counters"] for c in calls)


@pytest.mark.parametrize("cell", CELLS)
def test_reader_returns_none_with_spans_off(traced, cell):
    """A traced run with spans off after one with them on: the tracer's
    last root calls are the earlier run's, and the reader takes none."""
    res, _ = run_small(cell, trace=True)
    assert res["correct"]
    assert METRIC not in res["metrics"]


def test_reader_returns_none_when_calls_are_missing():
    """The tracer's last call read as a window of one: a value; as a window
    of more calls than the tracer holds, or of a call shorter than the
    tracer's: None."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    _one_call(ROOT)
    rec = runner.Record()
    rec.calls = [{"wall_s": 1e3}]
    assert reader.read(rec) is not None
    rec.calls = [{"wall_s": 0.0}]
    assert reader.read(rec) is None
    rec.calls = [{"wall_s": 1e3}] * (len(trace.calls()) + 1)
    assert reader.read(rec) is None


def test_reader_is_the_mean_a_call():
    """Three calls of one decoder, results dropped: the first class takes a
    new array and the next two reuse it. A window of the last three calls
    reads 2/3 a call, of the last two 1, and one with no reuse 0."""
    import numpy as np

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", METRIC)
    px = np.arange(16 * 8 * 3, dtype=np.uint8)
    stream = st.encode(px, st.SqoaDesc(16, 8, 3, 0, 0), backend="native")
    trace.enable()
    try:
        dec = st.BatchDecoder(device="cpu")
        for _ in range(3):
            dec([stream])
    finally:
        trace.disable()
    assert [c["counters"].get(COUNTER, 0) for c in trace.calls(3)] == \
        [0, 1, 1]
    rec = runner.Record()
    rec.calls = [{"wall_s": 1e3}] * 3
    assert reader.read(rec) == pytest.approx(2 / 3)
    rec.calls = [{"wall_s": 1e3}] * 2
    assert reader.read(rec) == 1.0
    _one_call(ROOT)  # a new decoder: a new array
    rec.calls = [{"wall_s": 1e3}]
    assert reader.read(rec) == 0.0
