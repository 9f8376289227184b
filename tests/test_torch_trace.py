"""The port's tracer (``seqoia_tpu_torch.utils.trace``) on the CPU: off by
default (no span recorded, no profiler range emitted); on under
``trace.enable()`` and under a ``torch.profiler`` session, off again after
either; the span trees of ``BatchDecoder`` (SQOA, gray SQOA to RGB and
``.qoi``), ``BatchEncoder`` and ``encode_large`` with their parents, call
ids, attributes and self times; the fixpoint's pass spans against
``decode_compat``'s own counts; the record's ring; and the launch counters
(one a kernel launch, none for a plain version on the CPU)."""

import collections

import numpy as np
import pytest
import torch

import seqoia_tpu_torch as st
from seqoia_tpu_torch import spec
from seqoia_tpu_torch.codec import decode_compat, decode_v2
from seqoia_tpu_torch.ops import (_build, compact, engine, frontend, pack,
                                  scan, sequential, slots)
from seqoia_tpu_torch.utils import corpus, trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    yield
    trace.disable()


def _pixels(kind, w=48, h=40, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "chain":  # four values: INDEX chains the fixpoint cannot settle
        return rng.integers(0, 4, w * h * 3, np.uint8)
    x = np.arange(w * h * 3) // 3
    return ((x * 7 + (x // w) * 3 + rng.integers(0, 2, x.size)) % 256
            ).astype(np.uint8)


def _stream(kind="smooth", compat=0, w=48, h=40):
    return st.encode(_pixels(kind, w, h), st.SqoaDesc(w, h, 3, 0, compat),
                     backend="native")


def _last_id():
    calls = trace.calls(1)
    return calls[0]["id"] if calls else None


def test_off_by_default_records_and_emits_nothing(monkeypatch):
    def emitted(name):
        raise AssertionError(f"a profiler range {name} while spans are off")

    monkeypatch.setattr(trace, "_record_function", emitted)
    assert not trace.is_on()
    assert trace.span("parallel.class", rows=1) is trace.span("x")
    before = _last_id()
    n0 = trace.counters().get("api.batch_decode", 0)
    st.BatchDecoder(device="cpu")([_stream(), _stream(compat=1)])
    assert _last_id() == before
    # the entry point's call count counts whether spans are on or not
    assert trace.counters()["api.batch_decode"] == n0 + 1


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_spans_turn_on_and_off(how):
    dec = st.BatchDecoder(device="cpu")
    stream = _stream()
    if how == "enable":
        trace.enable()
        assert trace.is_on()
        dec([stream])
        trace.disable()
        names = None
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            assert trace.is_on()
            dec([stream])
        names = {e.name for e in prof.events()}
    assert not trace.is_on()
    call = trace.calls(1)[0]
    assert call["name"] == "api.batch_decode"
    if names is not None:
        assert {"seqoia/" + s["name"] for s in call["spans"]} <= names
    before = _last_id()
    dec([stream])
    assert _last_id() == before


def _batch_decode(kind, compat):
    dec = st.BatchDecoder(device="cpu")
    out = dec([_stream(kind, compat), _stream(kind, compat, 40, 48)])
    assert all(r.error is None for r in out)
    return dec.last_timings


def _gray_to_rgb_decode():
    """Two gray streams decoded to RGB: K1 in mono mode, then K2's
    gray-to-RGB epilogue in the span ``codec.emit_pixels``."""
    streams = [st.encode(_pixels("smooth", w, h)[: w * h],
                         st.SqoaDesc(w, h, 1, 0, 0), backend="native")
               for w, h in ((48, 40), (40, 48))]
    dec = st.BatchDecoder(device="cpu")
    assert all(r.error is None for r in dec(streams, channels=3))
    return dec.last_timings


def _batch_encode():
    desc = st.SqoaDesc(48, 40, 3, 0, 0)
    out = st.BatchEncoder(device="cpu")([_pixels("smooth")] * 2, [desc] * 2)
    assert all(o is not None for o in out)


def _encode_large():
    desc = st.SqoaDesc(48, 40, 3, 0, 0)
    assert st.encode_large(_pixels("smooth"), desc, device="cpu") is not None


_PARALLEL = {"parallel.class", "parallel.stage.fill",
             "parallel.stage.dispatch", "parallel.wait",
             "parallel.unpack.copy"}
TREES = {
    # case: (call, root, the spans under the root)
    "sqoa_decode": (lambda: _batch_decode("smooth", 0), "api.batch_decode",
                    _PARALLEL | {"parallel.classify"}),
    "qoi_decode": (lambda: _batch_decode("chain", 1), "api.batch_decode",
                   _PARALLEL | {"parallel.classify", "codec.fixpoint.pass",
                                "codec.settle.pass", "codec.sequential",
                                "codec.emit_pixels"}),
    "gray_rgb_decode": (_gray_to_rgb_decode, "api.batch_decode",
                        _PARALLEL | {"parallel.classify",
                                     "codec.emit_pixels"}),
    "batch_encode": (_batch_encode, "api.batch_encode", _PARALLEL),
    "encode_large": (_encode_large, "api.encode_large",
                     {"parallel.stage.fill", "parallel.stage.dispatch",
                      "parallel.wait", "parallel.fetch",
                      "parallel.file_bytes"}),
}
# the span each span opens under
PARENTS = {"parallel.stage.fill": ("parallel.class", "api.encode_large"),
           "parallel.stage.dispatch": ("parallel.class", "api.encode_large"),
           "codec.fixpoint.pass": ("parallel.stage.dispatch",),
           "codec.settle.pass": ("parallel.stage.dispatch",),
           "codec.sequential": ("parallel.stage.dispatch",),
           "codec.emit_pixels": ("parallel.stage.dispatch",)}


@pytest.mark.parametrize("case", sorted(TREES))
def test_span_tree(case):
    run, root, want = TREES[case]
    trace.enable()
    timings = run()
    trace.disable()
    call = trace.calls(1)[0]
    spans = call["spans"]
    by_id = {s["id"]: s for s in spans}
    assert call["name"] == root and spans[0]["name"] == root
    assert spans[0]["parent"] is None and spans[0]["id"] == min(by_id)
    assert {s["name"] for s in spans[1:]} == want
    for s in spans:
        assert s["call"] == call["id"]
        assert s["start_ns"] <= s["end_ns"]
        kids = [k for k in spans if k["parent"] == s["id"]]
        assert s["self_ns"] == (s["end_ns"] - s["start_ns"] - sum(
            k["end_ns"] - k["start_ns"] for k in kids))
        assert all(s["start_ns"] <= k["start_ns"] <= k["end_ns"]
                   <= s["end_ns"] for k in kids)
        if s["parent"] is not None:
            parent = by_id[s["parent"]]["name"]
            assert parent in PARENTS.get(s["name"], (root, parent)), s
        if s["name"] == "parallel.class":
            assert set(s["attrs"]) == {"key", "rows", "in_bytes",
                                       "out_bytes", "device"}
            assert s["attrs"]["rows"] == 2 and s["attrs"]["device"] == "cpu"
        if s["name"] == "parallel.classify":
            assert s["parent"] == spans[0]["id"]
            assert s["attrs"] == {"images": 2, "classes": 1}
        if s["name"] == "parallel.wait":
            assert s["attrs"]["why"] in ("first", "unpack", "exact_total",
                                         "total")
        if s["name"] in ("codec.fixpoint.pass", "codec.settle.pass"):
            assert 0 <= s["attrs"]["unsettled"] <= s["attrs"]["rows"]
        if s["name"] == "codec.emit_pixels":
            assert set(s["attrs"]) == {"rows", "colch", "out_ch", "n_max"}
            assert s["attrs"]["rows"] == 2
    if root.startswith("api.batch"):
        assert spans[0]["attrs"] == {"images": 2, "classes": 1}
    if timings is not None:
        # the program's own timings of the phases hold its spans, but for
        # the header read before the first phase
        top = sum(s["end_ns"] - s["start_ns"] for s in spans
                  if s["parent"] == spans[0]["id"]
                  and s["name"] != "parallel.classify")
        assert top <= 1e9 * sum(timings.values()) + 1000


@pytest.mark.parametrize("iters", [1, 2, 12])
@pytest.mark.parametrize("kind", ["smooth", "chain", "mono"])
def test_pass_spans_match_the_fixpoints_counts(monkeypatch, kind, iters):
    monkeypatch.setattr(decode_compat, "_MAX_ITERS", iters)
    stats = []
    fn = decode_compat.decode_stream_compat_batched

    def counted(*a, **k):
        stats.append(k.setdefault("stats", {}))
        return fn(*a, **k)

    monkeypatch.setattr(decode_compat, "decode_stream_compat_batched",
                        counted)
    if kind == "mono":
        streams = [corpus.mono_qoi(np.random.default_rng(3), 24, 20)]
    else:
        streams = [_stream(kind, 1)]
    want = [st.decode(s, backend="native")[0] for s in streams]
    trace.enable()
    out = st.BatchDecoder(device="cpu")(streams)
    trace.disable()
    assert all(np.array_equal(r.pixels, w) for r, w in zip(out, want))
    (s,), names = stats, [x["name"] for x in trace.calls(1)[0]["spans"]]
    assert names.count("codec.fixpoint.pass") == s["passes"]
    assert names.count("codec.settle.pass") == s["settle_passes"]
    assert names.count("codec.sequential") == int(s["sequential_rows"] > 0)


def test_ring_drops_the_oldest_calls(monkeypatch):
    monkeypatch.setattr(trace, "_record", collections.deque(maxlen=4))
    trace.enable()
    for i in range(6):
        with trace.entry("test.root", i=i):
            with trace.span("test.child"):
                pass
    trace.disable()
    calls = trace.calls()
    ids = [c["id"] for c in calls]
    assert len(calls) == 4 and ids == list(range(ids[0], ids[0] + 4))
    assert [c["spans"][0]["attrs"]["i"] for c in calls] == [2, 3, 4, 5]
    seqs = [c["seq"] for c in calls]
    assert seqs == list(range(seqs[0], seqs[0] + 4))
    assert seqs[-1] == trace.counters()["test.root"]
    assert [c["name"] for c in trace.calls(2)] == ["test.root"] * 2
    assert trace.calls(0) == []


def test_counters_are_kept_per_call():
    trace.enable()
    with trace.entry("test.root"):
        trace.count("test.things", 3)
        trace.host_sync("test")
    trace.disable()
    # the entry's own count comes before its root opens
    assert trace.calls(1)[0]["counters"] == {
        "test.things": 3, "codec.host_syncs": 1, "codec.host_syncs.test": 1}


class _OnCard(torch.Tensor):
    """A CPU tensor that the kernels' wrappers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


LAUNCHES = {
    "K1": (lambda w: frontend.decode_front_compact(
        w(torch.zeros((1, 256), dtype=torch.uint8)), _i32(1), 16),
        {"K1": 1}),
    "K1.seg": (lambda w: frontend.decode_front_compact(
        w(torch.zeros((1, 256), dtype=torch.uint8)), _i32(1, 2), 16,
        seg=128, seg_px=8), {"K1": 1, "K1.seg": 1}),
    "K1.mono": (lambda w: frontend.decode_front_compact(
        w(torch.zeros((1, 256), dtype=torch.uint8)), _i32(1), 16,
        mode="mono"), {"K1": 1, "K1.mono": 1}),
    "K2": (lambda w: engine.place_emit(
        w(_i32(1, 4)), [w(_i32(1, 4))], _i32(1), _i32(1, 1), 16, (0,),
        decode_v2._epilogue(3, 4)), {"K2": 1}),
    "K2.conv": (lambda w: engine.place_emit(
        w(_i32(1, 4)), [w(_i32(1, 4))], _i32(1), _i32(1, 1), 16, (0,),
        decode_v2._epilogue(1, 3)), {"K2": 1, "K2.conv": 1}),
    "K4": (lambda w: pack.pack_words(w(_i32(1, 12)), 3), {"K4": 1}),
    "K5": (lambda w: compact.compact(w(torch.ones((1, 8), dtype=torch.bool)),
                                     w(_i32(1, 8)), [w(_i32(1, 8))]),
           {"K5": 1}),
    "K7": (lambda w: slots.slot_last_writer(w(_i32(1, 8)), w(_i32(1, 8)),
                                            w(_i32(1, 8))), {"K7": 1}),
    "K8": (lambda w: scan.tile_scan((w(_i32(1, 8)),), "max"), {"K8": 1}),
    "K9": (lambda w: sequential.sequential_decode(
        w(_i32(1, 4)), w(_i32(1, 4)), _i32(1)), {"K9": 1}),
    "K9.mono": (lambda w: sequential.sequential_decode(
        w(_i32(1, 4)), None, _i32(1), colch=1), {"K9.mono": 1}),
}


@pytest.mark.parametrize("kernel", sorted(LAUNCHES))
@pytest.mark.parametrize("on_card", [True, False])
def test_launch_counter(monkeypatch, kernel, on_card):
    """A launch on the card counts once under its kernel (a fake
    ``_build.launch`` stands in for the library); the plain version on the
    CPU counts nothing."""
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda lib, fn, dev, *a: launched.append(fn))
    run, want = LAUNCHES[kernel]
    before = trace.counters()
    run((lambda t: t.as_subclass(_OnCard)) if on_card else (lambda t: t))
    after = trace.counters()
    moved = {k[len("kernels.launches."):]: v - before.get(k, 0)
             for k, v in after.items()
             if k.startswith("kernels.launches.") and v != before.get(k, 0)}
    assert moved == (want if on_card else {})
    assert len(launched) == (1 if on_card else 0)


def test_root_per_thread():
    """A span opened on a thread with none open is a root of that thread;
    spans on another thread do not nest under it."""
    import threading

    trace.enable()
    with trace.entry("test.outer"):
        t = threading.Thread(target=lambda: trace.span("test.other")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    trace.disable()
    a, b = trace.calls(2)
    assert (a["name"], b["name"]) == ("test.other", "test.outer")
    assert [s["name"] for s in b["spans"]] == ["test.outer"]


def test_output_is_unchanged_by_spans():
    """The same call with spans on and off returns the same bytes."""
    desc = st.SqoaDesc(48, 40, 3, 0, 0)
    off = st.encode_large(_pixels("smooth"), desc, device="cpu")
    trace.enable()
    on = st.encode_large(_pixels("smooth"), desc, device="cpu")
    trace.disable()
    assert on == off and on.startswith(spec.pack_header(desc))
