"""The readers of the program's own spans and counters
(``harness/program_spans.py``), on small CPU runs with the program's tracer
turned on by the test: each reads its value; each returns None where the
window's calls were not all recorded; and every span and counter a reader
names occurs in a traced call of its entry point."""

import inspect

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness import runner
from benchmark.tests.small import run_small

# metric -> (its cell on the CPU, the root it reads, the spans or counter)
READS = {
    "parallel.unpack_copy_ms.decode": ("kodak24.sqoa_decode",
                                       "api.batch_decode",
                                       ["parallel.unpack.copy"]),
    "parallel.stage_fill_ms.decode": ("kodak24.sqoa_decode",
                                      "api.batch_decode",
                                      ["parallel.stage.fill"]),
    "parallel.wait_ms.decode": ("kodak24.sqoa_decode", "api.batch_decode",
                                ["parallel.wait"]),
    "codec.fixpoint_ms.decode": ("kodak24.qoi_decode", "api.batch_decode",
                                 ["codec.fixpoint.pass", "codec.settle.pass",
                                  "codec.sequential"]),
    "codec.host_syncs.decode": ("kodak24.qoi_decode", "api.batch_decode",
                                ["codec.host_syncs"]),
    "parallel.stage_ms.encode": ("s2tci.sqoa_encode", "api.encode_large",
                                 ["parallel.stage.fill",
                                  "parallel.stage.dispatch"]),
    "parallel.file_bytes_ms.encode": ("s2tci.sqoa_encode",
                                      "api.encode_large",
                                      ["parallel.file_bytes"]),
    "parallel.wait_ms.encode": ("s2tci.sqoa_encode", "api.encode_large",
                                ["parallel.wait"]),
}


def _chain_call():
    """A BatchDecoder call of a .qoi stream whose INDEX chains neither the
    fixpoint nor its restart settle (random pixels of four values), so K9
    decodes it: the small cells' photos settle before."""
    import numpy as np

    import seqoia_tpu_torch as st

    px = np.random.default_rng(1).integers(0, 4, 48 * 40 * 3, np.uint8)
    stream = st.encode(px, st.SqoaDesc(48, 40, 3, 0, 1), backend="native")
    st.BatchDecoder(device="cpu")([stream])


@pytest.fixture(scope="module")
def traced():
    """{cell: (result line, the window's root calls)} of one traced small
    run a cell with the tracer on, and {"chain": (None, [_chain_call's
    root call])}."""
    from seqoia_tpu_torch.utils import trace

    out = {}
    trace.enable()
    try:
        for cell in sorted({c for c, _, _ in READS.values()}):
            res, _ = run_small(cell, trace=True)
            out[cell] = (res, trace.calls(res["calls"]))
        _chain_call()
        out["chain"] = (None, trace.calls(1))
    finally:
        trace.disable()
    return out


def test_every_new_reader_is_in_the_manifest():
    man = mf.load_manifest()
    for name, (cell, _, _) in READS.items():
        assert name in {m["name"] for m in mf.cell_metrics(man, cell, True)}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_reads_a_traced_run(traced, metric):
    res, _ = traced[READS[metric][0]]
    assert res["correct"]
    assert res["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("metric", sorted(READS))
def test_named_spans_occur_in_the_entry(traced, metric):
    cell, root, names = READS[metric]
    calls = traced[cell][1] + (traced["chain"][1]
                               if root == "api.batch_decode" else [])
    src = inspect.getsource(mf.load_module("metrics", metric))
    assert f'"{root}"' in src
    assert calls and all(c["name"] == root for c in calls)
    for name in names:
        assert f'"{name}"' in src
        assert any(name in c["counters"] or any(
            s["name"] == name for s in c["spans"]) for c in calls), name


@pytest.mark.parametrize("cell", sorted({c for c, _, _ in READS.values()}))
def test_readers_return_none_with_spans_off(traced, cell):
    """A traced run with spans off after one with them on: the tracer's
    last root calls are the earlier run's, and no reader takes them."""
    res, _ = run_small(cell, trace=True)
    assert res["correct"]
    assert not set(res["metrics"]) & set(READS)


def _one_call(root):
    """One call of ``root`` on the CPU with the tracer on."""
    import numpy as np

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.utils import trace

    px = np.arange(16 * 8 * 3, dtype=np.uint8)
    desc = st.SqoaDesc(16, 8, 3, 0, 0)
    trace.enable()
    try:
        if root == "api.batch_decode":
            stream = st.encode(px, desc, backend="native")
            st.BatchDecoder(device="cpu")([stream])
        else:
            st.encode_large(px, desc, device="cpu")
    finally:
        trace.disable()


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_returns_none_when_calls_are_missing(metric):
    """The tracer's last call read as a window of one: a value; as a window
    of more calls than the tracer holds, or of a call shorter than the
    tracer's: None."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", metric)
    _one_call(READS[metric][1])
    rec = runner.Record()
    rec.calls = [{"wall_s": 1e3}]
    assert reader.read(rec) is not None
    rec.calls = [{"wall_s": 0.0}]
    assert reader.read(rec) is None
    rec.calls = [{"wall_s": 1e3}] * (len(trace.calls()) + 1)
    assert reader.read(rec) is None
