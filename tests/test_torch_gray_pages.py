"""Gray document pages through ``BatchDecoder`` and ``decode`` on the CPU at
every channel count, as a page classifier's loader asks for RVL-CDIP scans
as RGB (the benchmark's ``rvlcdip`` configuration), at 100-px pages of the
configuration's three aspects. The pages are the benchmark reference's
``mono_doc`` (``benchmark/reference``: ``corpus.make_images``,
``codec.encode``, the plain ``codec.decode``).

Held: every result byte for byte to the reference's decode at channels
0-4, and its desc's channels 1; the always-on counters of the gray route:
``parallel.mono.images`` moved by the page count, on the regular and on the
packed route, and ``codec.emit.rows`` by the rows K2 emits with a
channel conversion (at 3 and 4 channels; none at 0, 1 and 2) and by every
row of a ``.qoi`` batch; neither for a colour batch. Every K1 call of the gray
pages asks for K1's mono mode, and none of a colour batch does. (The plain
K1 on the CPU launches nothing and counts no launch:
``test_torch_trace.test_launch_counter`` holds ``kernels.launches.K1.mono``
through the card's wrapper.)"""

import pytest
import torch

import seqoia_tpu_torch as st
from benchmark.reference import codec, corpus
from seqoia_tpu_torch.ops import frontend
from seqoia_tpu_torch.parallel import batch
from seqoia_tpu_torch.utils import trace

torch.set_num_threads(1)

PAGES = [
    {"category": "letter", "generator": "mono_doc", "count": 3, "width": 77,
     "height": 100},
    {"category": "a4", "generator": "mono_doc", "count": 2, "width": 71,
     "height": 100},
    {"category": "landscape", "generator": "mono_doc", "count": 1,
     "width": 100, "height": 77},
]
# 64x64 pages fill their pixel bucket exactly: the icon class, packed
PACKED = [{"category": "icon", "generator": "mono_doc", "count": 4,
           "width": 64, "height": 64}]
PHOTOS = [{"category": "photo", "generator": "photo", "count": 3,
           "width": 40, "height": 24}]
SEED = 2**33 + 26


@pytest.fixture
def k1_modes(monkeypatch):
    """The mode of every K1 call."""
    modes = []
    plain = frontend.decode_front_compact

    def front(data, chunks_len, n_max, mode="alpha", **kw):
        modes.append(mode)
        return plain(data, chunks_len, n_max, mode=mode, **kw)

    monkeypatch.setattr(frontend, "decode_front_compact", front)
    return modes


def _streams(specs, qoi=False):
    images = [img for _, img in corpus.make_images(specs, SEED, "cpu")]
    return [codec.encode(img, img.shape[1], img.shape[0], img.shape[2],
                         qoi=qoi).numpy().tobytes() for img in images]


def _moved(before, name):
    return trace.counters().get(name, 0) - before.get(name, 0)


@pytest.mark.parametrize("route", ["regular", "packed"])
@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
def test_gray_pages(k1_modes, channels, route):
    streams = _streams(PAGES if route == "regular" else PACKED)
    dec = batch.BatchDecoder(device="cpu")
    before = trace.counters()
    out = dec(streams, channels)
    assert len(out) == len(streams)
    for r, data in zip(out, streams):
        want, desc = codec.decode(data, channels)
        assert r.error is None and r.desc.channels == 1
        assert (r.desc.width, r.desc.height) == desc[:2]
        assert r.pixels.tobytes() == bytes(want)
        px, d = st.decode(data, channels, device="cpu")
        assert d.channels == 1 and px.tobytes() == bytes(want)
    packed = dec.last_stats["packed_rows"]
    assert (packed > 0) == (route == "packed")
    assert dec.last_stats["host_rows"] == 0
    # BatchDecoder's one class, then one decode a page
    assert set(k1_modes) == {"mono"} and len(k1_modes) == 1 + len(streams)
    assert _moved(before, "parallel.mono.images") == len(streams)
    # a regular class emits a row an image, a packed one a row a packed row
    rows = packed if route == "packed" else len(streams)
    emitted = (rows + len(streams)) if channels in (3, 4) else 0
    assert _moved(before, "codec.emit.rows") == emitted


def test_qoi_batch_counts_its_emitted_rows():
    streams = _streams(PHOTOS, qoi=True)
    dec = batch.BatchDecoder(device="cpu")
    before = trace.counters()
    out = dec(streams)
    for r, data in zip(out, streams):
        assert r.pixels.tobytes() == bytes(codec.decode(data)[0])
    assert _moved(before, "codec.emit.rows") == len(streams)
    assert _moved(before, "parallel.mono.images") == 0


@pytest.mark.parametrize("channels", [0, 3])
def test_colour_batch_counts_no_gray(k1_modes, channels):
    streams = _streams(PHOTOS)
    dec = batch.BatchDecoder(device="cpu")
    before = trace.counters()
    out = dec(streams, channels)
    for r, data in zip(out, streams):
        assert r.pixels.tobytes() == bytes(codec.decode(data, channels)[0])
    assert k1_modes and "mono" not in k1_modes
    assert _moved(before, "parallel.mono.images") == 0
    assert _moved(before, "codec.emit.rows") == 0


def test_emit_span_holds_its_rows():
    """With spans on, one ``codec.emit_pixels`` span a class at 3 channels,
    under the class's dispatch, with its rows and shapes."""
    streams = _streams(PAGES)
    trace.enable()
    try:
        batch.BatchDecoder(device="cpu")(streams, 3)
    finally:
        trace.disable()
    call = trace.calls(1)[0]
    by_id = {s["id"]: s for s in call["spans"]}
    (span,) = [s for s in call["spans"] if s["name"] == "codec.emit_pixels"]
    assert span["attrs"] == {"rows": len(streams), "colch": 1, "out_ch": 3,
                             "n_max": 8192}
    assert by_id[span["parent"]]["name"] == "parallel.stage.dispatch"
    assert call["counters"]["codec.emit.rows"] == len(streams)
    assert call["counters"]["parallel.mono.images"] == len(streams)
