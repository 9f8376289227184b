"""``BatchDecoder``'s host work for a batch of small streams, on the CPU: each
distinct header read once a call, the packed rows filled through one
memoryview (``pack_segments``), and a class's results made from one list of
row views where no row is flagged and the class has one pixel count.

The streams and the truth come from the benchmark's reference
(``benchmark/reference``: ``corpus.make_images``, ``codec.encode``, the
plain ``codec.decode``). Held, for every batch: pixels byte-exact and in
input order, malformed and truncated streams in their error slots; the
always-on counters ``parallel.classify.header_hits`` (streams whose header
the call had already read) and ``parallel.classify.header_parses``
(distinct headers read), with spans on and off; a desc of its own for each
result; and ``pack_segments`` equal to a plain per-stream packing."""

import numpy as np
import pytest
import torch

from benchmark.reference import codec, corpus
from seqoia_tpu_torch import spec
from seqoia_tpu_torch.parallel import batch
from seqoia_tpu_torch.utils import corpus as port_corpus
from seqoia_tpu_torch.utils import trace

torch.set_num_threads(1)

SEED = 2**31 + 23
N = 64
BAD_HEADER, TRUNCATED = 17, 40   # places of the two bad streams
ROW_BYTES = 32768
MIN_LEN = spec.HEADER_SIZE + spec.PADDING_SIZE


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    yield
    trace.disable()


def _streams(sizes, seed=SEED):
    """SQOA streams of RGB photos with the generator's plateau off, ``count``
    of each ``(width, height, count)``, the sizes interleaved."""
    specs = [{"category": f"s{w}x{h}", "generator": "photo", "count": c,
              "width": w, "height": h, "args": {"plateau": 0.0}}
             for w, h, c in sizes]
    imgs = [img for _, img in corpus.make_images(specs, seed, "cpu")]
    order = np.random.default_rng(seed).permutation(len(imgs))
    return [codec.encode(imgs[i], imgs[i].shape[1], imgs[i].shape[0], 3)
            .numpy().tobytes() for i in order]


def _with_bad(streams):
    """The streams with a malformed header (7 channels) at ``BAD_HEADER``
    and a stream cut short of a header and end marker at ``TRUNCATED``."""
    out = list(streams)
    bad = bytearray(out[BAD_HEADER])
    bad[12] = 7
    out[BAD_HEADER] = bytes(bad)
    out[TRUNCATED] = out[TRUNCATED][: MIN_LEN - 1]
    return out


def _ref_sqoa(streams):
    """The streams with REF ops spliced into the first one that takes
    them: its packed row is flagged and goes to the host decoder."""
    rng = np.random.default_rng(SEED)
    out = list(streams)
    for j, s in enumerate(out):
        r = port_corpus.ref_sqoa(s, rng)
        if r is not None:
            out[j] = bytes(r)
            return out
    raise AssertionError("no stream took a REF op")


def _as(kind, s: bytes):
    if kind == "bytes":
        return s
    if kind == "bytearray":
        return bytearray(s)
    if kind == "memoryview":
        return memoryview(s)
    if kind == "memoryview_signed":   # a format other than "B"
        return memoryview(bytearray(s)).cast("b")
    return np.frombuffer(s, np.uint8).copy()


def _headers(streams):
    """The distinct headers a call reads: the first 15 bytes of every
    stream long enough to hold a header and the end marker."""
    return {bytes(s[: spec.HEADER_SIZE + 1]) for s in streams
            if len(s) >= MIN_LEN}


def _decode(streams, spans):
    """One call: (results, counter deltas)."""
    names = ("parallel.classify.header_hits", "parallel.classify.header_parses")
    before = trace.counters()
    if spans:
        trace.enable()
    try:
        out = batch.BatchDecoder(device="cpu")(streams)
    finally:
        trace.disable()
    after = trace.counters()
    return out, {n: after.get(n, 0) - before.get(n, 0) for n in names}


def _check(streams, out):
    """Byte-exact, in order; a malformed stream in its error slot; each
    result's desc its own object."""
    assert len(out) == len(streams)
    for s, r in zip(streams, out):
        want, desc = codec.decode(bytes(s))
        if want is None:
            assert (r.pixels, r.desc, r.error) == (None, None,
                                                   "invalid header")
            continue
        assert r.error is None
        assert (r.desc.width, r.desc.height, r.desc.channels,
                r.desc.colorspace, r.desc.qoi_compat) == desc
        assert bytes(np.asarray(r.pixels)) == bytes(want)
    good = [r for r in out if r.error is None]
    assert len({id(r.desc) for r in good}) == len(good)
    for a, b in zip(good, good[1:]):
        width = b.desc.width
        a.desc.width += 1
        assert b.desc.width == width
        a.desc.width -= 1


BATCHES = {
    "one_header": lambda: _streams([(32, 32, N)]),
    "bad_streams": lambda: _with_bad(_streams([(32, 32, N)])),
    "repeated_object": lambda: (lambda s: s[:5] + [s[3]] + s[5:])(
        _streams([(32, 32, 12)])),
    "two_sizes": lambda: _streams([(32, 32, 20), (16, 16, 9)]),
    # one regular-route class of two pixel counts (one stream and pixel
    # bucket): the per-image loop
    "uneven_class": lambda: _streams([(40, 24, 3), (30, 30, 3)]),
    "flagged_row": lambda: _ref_sqoa(_streams([(32, 32, 20)])),
}


@pytest.fixture(scope="module")
def made():
    return {name: make() for name, make in BATCHES.items()}


@pytest.mark.parametrize("spans", ["on", "off"])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_and_header_counters(made, name, spans):
    streams = made[name]
    out, moved = _decode(streams, spans == "on")
    _check(streams, out)
    parses = len(_headers(streams))
    assert moved["parallel.classify.header_parses"] == parses
    assert moved["parallel.classify.header_hits"] == sum(
        len(s) >= MIN_LEN for s in streams) - parses
    if name == "bad_streams":
        assert [i for i, r in enumerate(out) if r.error] == [BAD_HEADER,
                                                             TRUNCATED]
        assert moved["parallel.classify.header_hits"] == N - 1 - 2


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview",
                                  "memoryview_signed", "ndarray"])
def test_stream_types(made, kind):
    streams = made["bad_streams"]
    out, moved = _decode([_as(kind, s) for s in streams], spans=False)
    _check(streams, out)
    assert moved["parallel.classify.header_hits"] == N - 3
    assert moved["parallel.classify.header_parses"] == 2


def test_repeated_object_gets_results_of_its_own(made):
    streams = made["repeated_object"]
    assert streams[3] is streams[5]
    out, _ = _decode(streams, spans=False)
    a, b = out[3], out[5]
    assert a is not b and a.desc is not b.desc
    assert bytes(a.pixels) == bytes(b.pixels)
    assert not np.shares_memory(a.pixels, b.pixels)


def test_flagged_row_goes_to_the_host(made):
    dec = batch.BatchDecoder(device="cpu")
    out = dec(made["flagged_row"])
    _check(made["flagged_row"], out)
    assert dec.last_stats["host_rows"] == ROW_BYTES // 4096


def test_call_span_keeps_its_attributes(made):
    """The header cache adds counters, not span attributes."""
    streams = made["two_sizes"]
    trace.enable()
    batch.BatchDecoder(device="cpu")(streams)
    trace.disable()
    (call,) = trace.calls(1)
    (span,) = [s for s in call["spans"] if s["name"] == "parallel.classify"]
    assert span["attrs"] == {"images": len(streams), "classes": 2}
    assert call["counters"]["parallel.classify.header_parses"] == 2
    assert call["counters"]["parallel.classify.header_hits"] == \
        len(streams) - 2


def _plain_pack(streams, seg):
    """The packed rows and segment lengths, one stream at a time."""
    k = ROW_BYTES // seg
    rows = -(-len(streams) // k)
    buf = np.zeros((rows, ROW_BYTES), np.uint8)
    slens = np.zeros((rows, k), np.int32)
    for j, s in enumerate(streams):
        r, c = divmod(j, k)
        data = bytes(s)
        buf[r, c * seg: c * seg + len(data)] = list(data)
        slens[r, c] = len(data) - spec.PADDING_SIZE
    return buf, slens


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview",
                                  "memoryview_signed", "ndarray"])
@pytest.mark.parametrize("seg", [128, 1024, 4096])
def test_pack_segments_matches_a_plain_packing(seg, kind):
    """Random bytes of MIN_LEN to ``seg`` bytes, a row and a half and one
    more stream: full rows, a part row, empty segments after the last."""
    k = ROW_BYTES // seg
    rng = np.random.default_rng(seg)
    lens = rng.integers(MIN_LEN, seg + 1, k + k // 2 + 1)
    lens[:2] = (MIN_LEN, seg)
    streams = [rng.integers(1, 256, n, dtype=np.uint8).tobytes()
               for n in lens]
    buf, slens = batch.pack_segments([_as(kind, s) for s in streams], seg)
    want_buf, want_slens = _plain_pack(streams, seg)
    assert buf.dtype == torch.uint8 and slens.dtype == torch.int32
    assert np.array_equal(buf.numpy(), want_buf)
    assert np.array_equal(slens.numpy(), want_slens)
