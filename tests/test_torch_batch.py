"""``BatchDecoder`` and ``BatchEncoder`` of the port against the JAX
package's and the native oracle: mixed lists, the icon class on the packed
route, error slots, one front and one K2 an encode class, the bound on
outstanding device bytes, the out-of-memory ladders, and the decoder's
pool of host arrays for results (never one a caller still holds, only
the last two calls', freed by reference counting alone), and the lists
both coders return, freed by reference counting alone too.

The port runs with ``device="cpu"`` (the kernels' plain versions), the JAX
decoder and encoder on conftest's virtual CPU devices. Images are made from a seed with
numpy; pixels and streams are compared exactly (tolerance 0).
"""

import gc
import sys

import numpy as np
import pytest
import torch

import seqoia_tpu_torch as st
from conftest import KINDS, gen_pixels
from seqoia_tpu import native
from seqoia_tpu.parallel import batch as jbatch
from seqoia_tpu_torch.parallel import batch
from seqoia_tpu_torch.utils import trace
from test_torch_packed_decode import gen as icon_pixels

# one thread per process: the suite runs several workers, and the plain
# versions' many small tensor ops only contend when each takes every core
torch.set_num_threads(1)


def _stride(ch):
    return (1 if ch < 3 else 3) + (1 - (ch & 1))


def _image(rng, w, h, ch, kind, compat=0):
    return native.encode(gen_pixels(rng, w * h, _stride(ch), kind), w, h, ch,
                         0, compat)


def _icons(rng, ch, count):
    kinds = ["palette", "runs", "luma", "solid"]
    return [native.encode(icon_pixels(rng, kinds[i % 4], _stride(ch)), 64, 64,
                          ch, 0, 0) for i in range(count)]


def _mixed():
    rng = np.random.default_rng(11)
    ref = bytearray(_image(rng, 30, 30, 4, "luma"))
    ref[15] = 0x05  # a REF op: the card hands the row back
    return (
        _icons(rng, 4, 9) + _icons(rng, 3, 3) + _icons(rng, 1, 2)
        + [_image(rng, 100, 60, 3, "luma"), _image(rng, 90, 70, 3, "noise"),
           _image(rng, 64, 48, 4, "alpha_churn"),
           _image(rng, 50, 50, 2, "sparse_delta"),
           _image(rng, 48, 48, 3, "palette", compat=1),
           _image(rng, 40, 40, 4, "sparse_delta", compat=1),
           bytes(ref), b"not an image at all, but long enough", b""])


def _same(results, streams, channels=0):
    for i, (r, s) in enumerate(zip(results, streams)):
        want, d = native.decode(s, channels)
        if want is None:
            assert r.pixels is None and r.error, i
        else:
            assert r.error is None and np.array_equal(r.pixels, want), i
            assert tuple(r.desc)[:3] == tuple(d)[:3] if hasattr(
                r.desc, "__iter__") else r.desc.width == d[0]


def test_mixed_list_matches_jax_and_native():
    streams = _mixed()
    dec = st.BatchDecoder(device="cpu")
    ours = dec(streams)
    _same(ours, streams)
    theirs = jbatch.BatchDecoder()(streams)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert (a.pixels is None) == (b.pixels is None), i
        assert a.error == b.error, i
        if a.pixels is not None:
            assert np.array_equal(a.pixels, np.asarray(b.pixels)), i
            assert (a.desc.width, a.desc.height, a.desc.channels,
                    a.desc.qoi_compat) == (b.desc.width, b.desc.height,
                                           b.desc.channels, b.desc.qoi_compat)
    # the three icon classes rode packed rows (9 RGBA in 8192-byte segments
    # or smaller, 3 RGB, 2 gray); only the REF stream went to the host
    assert dec.last_stats["packed_rows"] >= 3
    assert dec.last_stats["host_rows"] == 1
    assert ours[-2].error == "invalid header" and ours[-1].error
    assert set(dec.last_timings) == {"stage", "compute", "fetch", "host"}


@pytest.mark.parametrize("channels", [3, 4, 1])
def test_forced_channels(channels):
    streams = _mixed()[:17]
    dec = st.BatchDecoder(device="cpu")
    _same(dec(streams, channels), streams, channels)
    assert dec.last_stats["packed_rows"] >= 3


def test_icon_class_takes_the_packed_route(monkeypatch):
    """At least two same-size images of exactly n_max pixels with small
    streams ride decode_stream_packed; a lone icon, an icon that does not
    fill its pixel bucket and a large stream do not."""
    rng = np.random.default_rng(2)
    calls = []
    packed = batch.decode_v2.decode_stream_packed
    monkeypatch.setattr(
        batch.decode_v2, "decode_stream_packed",
        lambda data, slens, **kw: calls.append((tuple(data.shape), kw["seg"]))
        or packed(data, slens, **kw))
    icons = [native.encode(icon_pixels(rng, "luma", 4), 64, 64, 4, 0, 0)
             for _ in range(21)]
    buckets = {}
    for s in icons:
        seg = 1 << (len(s) - 1).bit_length()
        buckets[seg] = buckets.get(seg, 0) + 1
    assert all(c >= 2 for c in buckets.values()), buckets
    want = [((-(-c // (32768 // seg)), 32768), seg)
            for seg, c in buckets.items()]
    dec = st.BatchDecoder(device="cpu")
    _same(dec(icons), icons)
    assert calls == want
    assert dec.last_stats == {"early_drains": 0, "oom_redispatch": 0,
                              "packed_rows": sum(w[0][0] for w in want),
                              "host_rows": 0}
    calls.clear()
    others = [icons[0], _image(rng, 60, 60, 3, "luma"),
              _image(rng, 60, 60, 3, "luma"), _image(rng, 200, 200, 3, "noise"),
              _image(rng, 200, 200, 3, "noise")]
    _same(dec(others), others)
    assert calls == [] and dec.last_stats["packed_rows"] == 0


def test_mono_qoi_goes_to_the_host_pool_counted():
    """Mono .qoi (a decoder-only stream no encoder writes), once sent to the
    host pool, decodes on the card path now: no row goes to the host, and
    the pixels equal the native codec's."""
    rng = np.random.default_rng(4)
    s = bytearray(_image(rng, 20, 20, 3, "luma", compat=1))
    s[12] = 1  # the header's channels byte: now a mono .qoi stream
    streams = [bytes(s), _image(rng, 20, 20, 3, "luma")]
    dec = st.BatchDecoder(device="cpu")
    _same(dec(streams), streams)
    assert dec.last_stats["host_rows"] == 0


def _classes(rng):
    """Four classes in dispatch order: A small, B large, C and D small."""
    return [_image(rng, 8, 8, 3, "luma"), _image(rng, 200, 100, 3, "noise"),
            _image(rng, 8, 8, 1, "luma"), _image(rng, 8, 8, 4, "luma")]


def test_drain_bound():
    """Past the bound on outstanding bytes the oldest class drains before
    the next dispatch; the results do not change."""
    streams = _classes(np.random.default_rng(6))
    dec = st.BatchDecoder(device="cpu", max_outstanding_bytes=1)
    _same(dec(streams), streams)
    assert dec.last_stats["early_drains"] == 3
    dec = st.BatchDecoder(device="cpu")
    _same(dec(streams), streams)
    assert dec.last_stats["early_drains"] == 0


def test_oom_ladder_halves_down_to_an_error_slot(monkeypatch):
    """A class that does not fit is re-run in halves; a single image that
    still does not fit comes back as its error slot, and nothing the card
    failed at is decoded on the host."""
    rng = np.random.default_rng(8)
    streams = [_image(rng, 40, 40, 3, "luma") for _ in range(5)] \
        + [_image(rng, 8, 8, 1, "luma")]
    dec = st.BatchDecoder(device="cpu")
    run = dec._run
    seen = []

    def tight(items, *key_dev):
        seen.append(len(items))
        if len(items) > 2 or any(it[0] == 4 for it in items):  # 4 never fits
            raise torch.cuda.OutOfMemoryError("mocked")
        return run(items, *key_dev)

    monkeypatch.setattr(dec, "_run", tight)
    monkeypatch.setattr(
        dec, "_host_pool",
        lambda *a: pytest.fail("an out-of-memory image went to the host"))
    results = dec(streams)
    # 5 -> (2, 3 -> (1, 2)): image 4 sits in the last pair -> (1, 1)
    assert seen == [5, 5, 2, 3, 1, 2, 1, 1, 1]
    assert dec.last_stats["oom_redispatch"] == 7
    assert dec.last_stats["host_rows"] == 0
    assert results[4].pixels is None
    assert results[4].error == "out of device memory"
    keep = [i for i in range(len(streams)) if i != 4]
    _same([results[i] for i in keep], [streams[i] for i in keep])


def test_oom_at_dispatch_drains_the_queue_and_resets_outstanding(monkeypatch):
    """An out-of-memory error at a dispatch drains every queued class and
    re-runs the failed one; the outstanding-bytes count restarts from zero,
    so the classes dispatched afterwards are not drained early for bytes
    that are no longer held."""
    a, big, c, d = _classes(np.random.default_rng(6))
    # the large class first: alone in the queue it is not drained early,
    # but its bytes, if they stayed in the count, would drain C before D
    streams = [big, a, c, d]
    dec = st.BatchDecoder(device="cpu", max_outstanding_bytes=60000)
    run = dec._run
    state = {"failed": False, "order": []}

    def flaky(items, *key_dev):
        state["order"].append(items[0][0])
        if not state["failed"] and items[0][0] == 1:  # at its dispatch
            state["failed"] = True
            raise torch.cuda.OutOfMemoryError("mocked")
        return run(items, *key_dev)

    monkeypatch.setattr(dec, "_run", flaky)
    _same(dec(streams), streams)
    assert state["order"] == [0, 1, 1, 2, 3]
    assert dec.last_stats["oom_redispatch"] == 1
    # the large class was drained to make room and the failed one re-run
    # and finished at once: the count is back at 0, and C and D together
    # stay below the bound
    assert dec.last_stats["early_drains"] == 0
    assert dec.last_stats["host_rows"] == 0


def test_corpus_decode():
    streams = _mixed()[:4]
    _same(st.corpus_decode(streams, device="cpu"), streams)


# --- the results' host memory ------------------------------------------------

def _one_class(rng, count=3):
    """``count`` noise photos of 40x30 RGB: different streams, one class."""
    return [_image(rng, 40, 30, 3, "noise") for _ in range(count)]


def _reuses():
    return trace.counters().get("parallel.unpack.reuse", 0)


# how a caller holds a result: (what it keeps of one, the pixels that
# reads back, the same part of the reference's pixels)
_HOLDS = {
    "results": (lambda r: r, lambda h: h.pixels, lambda w: w),
    "slice": (lambda r: r.pixels[7:300], lambda h: h, lambda w: w[7:300]),
    "from_numpy": (lambda r: torch.from_numpy(r.pixels), lambda h: h.numpy(),
                   lambda w: w),
    "memoryview": (lambda r: memoryview(r.pixels),
                   lambda h: np.asarray(h), lambda w: w),
}


@pytest.mark.parametrize("hold", sorted(_HOLDS))
def test_a_held_result_is_never_overwritten(hold):
    """Call A's results, held as results, slices, tensors or memoryviews,
    stay byte-exact while calls B and C decode other streams of the same
    class: C reuses B's array (the pool is in use), never A's."""
    keep, read, part = _HOLDS[hold]
    rng = np.random.default_rng(21)
    a, b, c = _one_class(rng), _one_class(rng), _one_class(rng)
    dec = st.BatchDecoder(device="cpu")
    res = dec(a)
    held = [keep(r) for r in res]
    del res
    reused = _reuses()
    _same(dec(b), b)
    assert _reuses() == reused
    _same(dec(c), c)
    assert _reuses() == reused + 1
    for h, s in zip(held, a):
        want, _ = native.decode(s, 0)
        assert np.array_equal(read(h), part(want))


def test_dropped_results_free_their_array_for_the_call_after_next():
    """A caller that holds one call's results while the next decodes: the
    first two calls take new arrays, every later one reuses the array of
    the call before last, which reference counting alone frees (the
    garbage collector is off); the span says so."""
    rng = np.random.default_rng(22)
    lists = [_one_class(rng) for _ in range(5)]
    dec = st.BatchDecoder(device="cpu")
    last = None
    gc.disable()
    trace.enable()
    try:
        for k, streams in enumerate(lists):
            before = trace.counters()
            out = dec(streams)
            after = trace.counters()
            _same(out, streams)
            if last is not None:
                _same(last, lists[k - 1])
            reused = after.get("parallel.unpack.reuse", 0) - before.get(
                "parallel.unpack.reuse", 0)
            fresh = after.get("parallel.unpack.fresh", 0) - before.get(
                "parallel.unpack.fresh", 0)
            assert (reused, fresh) == ((1, 0) if k >= 2 else (0, 1)), k
            copy, = [sp for sp in trace.calls(1)[0]["spans"]
                     if sp["name"] == "parallel.unpack.copy"]
            assert copy["attrs"]["reused"] is (k >= 2)
            last = out
            del out
    finally:
        trace.disable()
        gc.enable()


@pytest.mark.parametrize("classes", [1, 2])
def test_the_pool_keeps_the_last_two_calls_arrays(classes):
    """Every result held over eight calls: no array is reused, and the
    decoder keeps only the arrays of its last two calls."""
    rng = np.random.default_rng(23)
    extra = [_image(rng, 8, 8, 1, "luma")] if classes == 2 else []
    dec = st.BatchDecoder(device="cpu")
    reused = _reuses()
    held = [dec(_one_class(rng) + extra) for _ in range(8)]
    assert _reuses() == reused
    last_two = {id(r.pixels.base) for res in held[-2:] for r in res}
    assert len(last_two) == 2 * classes
    assert {id(a) for a in dec._pool} == last_two


@pytest.mark.parametrize("route", ["mixed", "packed", "qoi"])
def test_a_reused_array_gives_the_pixels_of_a_new_one(route):
    """Mixed classes, the packed icon route and a .qoi class: a second
    call, through the first's arrays (filled with junk first, so a byte
    it does not write shows), gives the first's pixels."""
    rng = np.random.default_rng(24)
    streams = {
        "mixed": _mixed,
        "packed": lambda: [native.encode(icon_pixels(rng, "luma", 4), 64, 64,
                                         4, 0, 0) for _ in range(6)],
        "qoi": lambda: [_image(rng, 40, 30, 3, "luma", compat=1)
                        for _ in range(3)],
    }[route]()
    dec = st.BatchDecoder(device="cpu")
    first = dec(streams)
    want = [None if r.pixels is None else r.pixels.copy() for r in first]
    del first
    for k in range(len(dec._pool)):
        dec._pool[k].fill(0xA5)
    before = trace.counters()
    second = dec(streams)
    after = trace.counters()
    assert after.get("parallel.unpack.fresh", 0) == before.get(
        "parallel.unpack.fresh", 0)
    assert after["parallel.unpack.reuse"] > before.get(
        "parallel.unpack.reuse", 0)
    if route == "packed":
        assert dec.last_stats["packed_rows"] > 0
    for i, (r, w) in enumerate(zip(second, want)):
        assert (r.pixels is None) == (w is None), i
        assert w is None or np.array_equal(r.pixels, w), i
    _same(second, streams)


# --- BatchEncoder -----------------------------------------------------------

# four sizes in one pixel bucket (2048) of both packages: one class each
_ENC_SHAPES = [(37, 29), (40, 40), (45, 45), (33, 50)]


def _enc_list(rng, ch):
    """Every conftest kind at channels ch, sizes cycling through
    _ENC_SHAPES, as SQOA and (color) .qoi, plus pixels=None and two invalid
    descs (a zero width; .qoi of a mono source)."""
    images, descs = [], []
    for i, kind in enumerate(KINDS):
        w, h = _ENC_SHAPES[i % len(_ENC_SHAPES)]
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        for compat in ((0, 1) if ch >= 3 else (0,)):
            images.append(pix)
            descs.append(st.SqoaDesc(w, h, ch, (i + compat) % 2, compat))
    images += [None, np.zeros(64, np.uint8), np.zeros(64, np.uint8)]
    descs += [st.SqoaDesc(8, 8, ch), st.SqoaDesc(0, 8, ch),
              st.SqoaDesc(8, 8, 1, 0, 1)]
    return images, descs


def _native_enc(images, descs):
    return [None if p is None or not st.spec.validate_encode_desc(d) else
            native.encode(p, d.width, d.height, d.channels, d.colorspace,
                          d.qoi_compat) for p, d in zip(images, descs)]


@pytest.mark.parametrize("ch", [1, 2, 3, 4, 5, 6])
def test_batch_encode_matches_jax_and_native(ch):
    """BatchEncoder's streams against the JAX corpus_encode's and
    native.encode's: the conftest kinds at several sizes in one class,
    SQOA and .qoi, an image without pixels and invalid descs (None)."""
    images, descs = _enc_list(np.random.default_rng(1000 + ch), ch)
    want = _native_enc(images, descs)
    enc = st.BatchEncoder(device="cpu")
    ours = enc(images, descs)
    assert ours == want
    assert ours[-3:] == [None, None, None]
    jdescs = [jbatch.spec.SqoaDesc(d.width, d.height, d.channels,
                                   d.colorspace, d.qoi_compat) for d in descs]
    assert jbatch.corpus_encode(images, jdescs) == ours
    assert enc.last_stats == {"early_drains": 0, "oom_redispatch": 0,
                              "oom_errors": 0}
    assert set(enc.last_timings) == {"stage", "compute", "fetch", "host"}
    assert enc.last_timings["host"] == 0


def _enc_classes(rng):
    """Five classes in dispatch order: RGB SQOA, gray+alpha SQOA, RGBA
    .qoi, RGBA SQOA (stride 4: no K4) and gray SQOA, of two or three
    images each, sizes varied inside a class."""
    out = []
    for ch, compat, shapes in ((3, 0, [(30, 20), (17, 31)]),
                               (2, 0, [(8, 8), (7, 9), (8, 7)]),
                               (4, 1, [(20, 20), (31, 16)]),
                               (4, 0, [(9, 9), (10, 12)]),
                               (1, 0, [(5, 5), (3, 7)])):
        for w, h in shapes:
            out.append((gen_pixels(rng, w * h, _stride(ch), "luma"),
                        st.SqoaDesc(w, h, ch, 0, compat)))
    return [p for p, _ in out], [d for _, d in out]


@pytest.mark.parametrize("bound", [None, 1])
def test_one_front_and_one_k2_per_encode_class(bound, monkeypatch):
    """Each class runs one K2, sized from the exact totals, and a SQOA
    class one K3; each class of stride 1-3 one K4, stride 4 none; with
    the queue kept (the default bound) or drained before each dispatch
    (a bound of 1 byte). The streams equal native.encode's."""
    from seqoia_tpu_torch.ops import encode_front, engine, pack

    calls = {"K2": [], "K3": 0, "K4": []}

    def counted(key, fn, arg=None):
        def run(*a, **k):
            if arg is None:
                calls[key] += 1
            else:
                calls[key].append(arg(a, k))
            return fn(*a, **k)
        return run

    monkeypatch.setattr(engine, "place_emit", counted(
        "K2", engine.place_emit, lambda a, k: (a[0].shape[0], a[4])))
    monkeypatch.setattr(encode_front, "encode_front_compact", counted(
        "K3", encode_front.encode_front_compact))
    monkeypatch.setattr(pack, "pack_words", counted(
        "K4", pack.pack_words, lambda a, k: a[1]))
    images, descs = _enc_classes(np.random.default_rng(21))
    want = _native_enc(images, descs)
    enc = st.BatchEncoder(device="cpu", max_outstanding_bytes=bound)
    assert enc(images, descs) == want
    assert enc.last_stats["early_drains"] == (4 if bound else 0)
    body = [len(x) - (14 if d.qoi_compat else 15) for x, d in zip(want, descs)]
    sizes = [2, 3, 2, 2, 2]
    caps, i = [], 0
    for b in sizes:
        caps.append((b, -(-max(body[i: i + b]) // 4) * 4))
        i += b
    assert calls == {"K2": caps, "K3": 4, "K4": [3, 2, 1]}


def test_encoder_drain_bound():
    """Past the bound on outstanding bytes the oldest class drains before
    the next dispatch; the streams do not change."""
    images, descs = _enc_classes(np.random.default_rng(22))
    want = _native_enc(images, descs)
    enc = st.BatchEncoder(device="cpu", max_outstanding_bytes=1)
    assert enc(images, descs) == want
    assert enc.last_stats["early_drains"] == 4
    enc = st.BatchEncoder(device="cpu")
    assert enc(images, descs) == want
    assert enc.last_stats["early_drains"] == 0


def test_encoder_oom_ladder_halves_down_to_none(monkeypatch):
    """A class that does not fit is re-run in halves; a single image that
    still does not fit gets None and is counted, and nothing is encoded on
    the host."""
    rng = np.random.default_rng(23)
    images = [gen_pixels(rng, 40 * 40, 3, "luma") for _ in range(5)] \
        + [gen_pixels(rng, 64, 1, "luma")]
    descs = [st.SqoaDesc(40, 40, 3)] * 5 + [st.SqoaDesc(8, 8, 1)]
    want = _native_enc(images, descs)
    enc = st.BatchEncoder(device="cpu")
    run = enc._run
    seen = []

    def tight(items, *key_dev):
        seen.append(len(items))
        if len(items) > 2 or any(it[0] == 4 for it in items):  # 4 never fits
            raise torch.cuda.OutOfMemoryError("mocked")
        return run(items, *key_dev)

    monkeypatch.setattr(enc, "_run", tight)
    monkeypatch.setattr(native, "encode", lambda *a: pytest.fail(
        "an out-of-memory image went to the host"))
    results = enc(images, descs)
    # 5 -> (2, 3 -> (1, 2)): image 4 sits in the last pair -> (1, 1)
    assert seen == [5, 5, 2, 3, 1, 2, 1, 1, 1]
    assert enc.last_stats == {"early_drains": 0, "oom_redispatch": 7,
                              "oom_errors": 1}
    assert results[4] is None
    assert results[:4] + results[5:] == want[:4] + want[5:]


def test_encoder_oom_at_k2_drains_and_degrades(monkeypatch):
    """An out-of-memory error at a class's K2 (its output allocation)
    drains the queue and re-runs that class in halves; the streams do not
    change."""
    from seqoia_tpu_torch.ops import engine

    images, descs = _enc_classes(np.random.default_rng(24))
    want = _native_enc(images, descs)
    enc = st.BatchEncoder(device="cpu")
    place_emit, finish = engine.place_emit, enc._finish
    log = []

    def tight(*a, **k):
        log.append(("K2", a[0].shape[0]))
        if a[0].shape[0] == 3:  # the gray+alpha class, whole
            raise torch.cuda.OutOfMemoryError("mocked")
        return place_emit(*a, **k)

    def finished(entry, results):
        log.append(("done", len(entry.items)))
        return finish(entry, results)

    monkeypatch.setattr(engine, "place_emit", tight)
    monkeypatch.setattr(enc, "_finish", finished)
    assert enc(images, descs) == want
    # RGB queued; gray+alpha fails at its K2: the queue drains (RGB
    # done), the class re-runs whole, fails again and halves, 1 + 2; then
    # the last three classes queue and drain at the end
    assert log == [("K2", 2), ("K2", 3), ("done", 2), ("K2", 3), ("K2", 1),
                   ("done", 1), ("K2", 2), ("done", 2), ("K2", 2), ("K2", 2),
                   ("K2", 2), ("done", 2), ("done", 2), ("done", 2)]
    assert enc.last_stats == {"early_drains": 0, "oom_redispatch": 3,
                              "oom_errors": 0}


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
@pytest.mark.parametrize("coder", ["decoder", "encoder"])
def test_results_are_freed_by_reference_counting_alone(coder, ladder,
                                                       monkeypatch):
    """With the garbage collector off, the list a call returns has no
    referrer but the caller, after a plain call and after the out-of-memory
    ladder (every part of more than one image fails): no reference cycle
    of the call holds it."""
    rng = np.random.default_rng(26)
    if coder == "decoder":
        coder = st.BatchDecoder(device="cpu")
        args = (_one_class(rng),)
    else:
        coder = st.BatchEncoder(device="cpu")
        args = ([gen_pixels(rng, 64, 3, "luma") for _ in range(3)],
                [st.SqoaDesc(8, 8, 3)] * 3)
    if ladder:
        run = coder._run

        def tight(items, *key_dev):
            if len(items) > 1:
                raise torch.cuda.OutOfMemoryError("mocked")
            return run(items, *key_dev)

        monkeypatch.setattr(coder, "_run", tight)
    gc.disable()
    try:
        out = coder(*args)
        refs = sys.getrefcount(out)
    finally:
        gc.enable()
    assert refs == 2  # the caller's name and getrefcount's argument
    # 3 fails, re-runs whole and fails again -> (1, 2 -> (1, 1)): five
    # re-dispatches, and every image fits
    assert coder.last_stats["oom_redispatch"] == (5 if ladder else 0)
    assert all(r is not None and getattr(r, "error", None) is None
               for r in out)


def test_corpus_encode_and_the_exports():
    images, descs = _enc_classes(np.random.default_rng(25))
    assert st.corpus_encode(images, descs, device="cpu") == _native_enc(
        images, descs)
    from seqoia_tpu_torch import parallel

    for name in ("BatchEncoder", "corpus_encode"):
        assert name in st.__all__ and name in parallel.__all__
        assert getattr(st, name) is getattr(parallel, name)
