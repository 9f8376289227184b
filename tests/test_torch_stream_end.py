"""Every decode entry point of the port at the end of the stream, against
the native codec.

The reference peeks for an alpha modifier after every op of a color SQOA
stream (seqoia.h:777-783) and checks no bound there, so after the last op
it reads the end marker: its first byte, or the byte after a last op whose
body runs into it. A valid marker starts with 0, so only malformed streams
show it. The port follows the native codec, which copies that peek; mono
and ``.qoi`` streams have none. The oracle is the reference package's
``seqoia_tpu.native.decode`` (its peek is at sqoa_native.c:584), not the
port's own copy of the C runtime, which the port's host route calls: the
port's copy only builds the input streams, in ``utils/corpus``. Entry points:
``decode``, ``decode_large``, ``decode_large_shardmap(n_shards=4)``,
``corpus_decode`` on an icon class (K1's segment mode) and on a plain
class, and ``decode`` with ``SEQOIA_REF_CUDA=1`` on streams with a REF op
(K10), all with ``device="cpu"`` (the kernels' plain versions). Pixels are
compared exactly (tolerance 0). The streams come from
``utils/corpus.stream_end_stream`` and ``malformed_streams``, the ones
``chip_smoke.py`` sends through the card.
"""

import numpy as np
import pytest
import torch

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from seqoia_tpu import native
from seqoia_tpu_torch import native as port_native
from seqoia_tpu_torch.parallel import tiled
from seqoia_tpu_torch.utils import corpus

# one thread per process: the suite runs several workers
torch.set_num_threads(1)

ENTRIES = ("decode", "decode_large", "shardmap", "corpus_icon",
           "corpus_plain", "ref_cuda")
CHANNELS = (1, 2, 3, 4)
OUT_CH = (0, 2, 4)
MARKER = tuple(range(8))

FUZZ = 300

#: the first repro: a 4x1 RGB image (RGB 0A 14 1E, a RUN of 3) whose end
#: marker starts with 0x6A, an alpha modifier of -6
RGB_REPRO = bytes.fromhex("53716f61" "00000004" "00000001" "03" "00" "31"
                          "fe0a141e" "c2" "6a00000000000001")


def _decode(entry, streams, oc, monkeypatch):
    """Each stream through ``entry`` at ``oc`` channels: [pixels or None]."""
    if entry in ("corpus_icon", "corpus_plain"):
        return [r.pixels for r in st.corpus_decode(streams, oc, device="cpu")]
    if entry == "ref_cuda":
        monkeypatch.setenv("SEQOIA_REF_CUDA", "1")
    fn = {"decode": st.decode, "ref_cuda": st.decode,
          "decode_large": tiled.decode_large,
          "shardmap": lambda s, c, device: tiled.decode_large_shardmap(
              s, c, n_shards=4, device=device)}[entry]
    return [fn(s, oc, device="cpu")[0] for s in streams]


def _mismatches(entry, streams, oc, monkeypatch):
    """The indices of the streams whose pixels differ from native.decode's
    (or where one side refuses the stream and the other does not)."""
    bad = []
    for i, (s, got) in enumerate(zip(streams,
                                     _decode(entry, streams, oc,
                                             monkeypatch))):
        want = native.decode(s, oc)[0]
        if (got is None) != (want is None) or (
                want is not None and not np.array_equal(got, want)):
            bad.append(i)
    return bad


def _edge_streams(entry, last, channels):
    """The stream of each marker position, with a REF op for ``ref_cuda``,
    at a size no icon class takes for ``corpus_plain``."""
    return [corpus.stream_end_stream(channels, last, pos,
                                     ref=entry == "ref_cuda",
                                     icon=entry != "corpus_plain")
            for pos in MARKER]


@pytest.mark.parametrize("last", tuple(corpus.END_OPS))
@pytest.mark.parametrize("entry", ENTRIES)
def test_alpha_byte_in_the_marker(entry, last, monkeypatch):
    """The last op of each kind (RGB, RGBA, LUMA, RUN, BIGRUN, two cut short
    into the marker), an alpha-range byte at each of the 8 marker
    positions, sources of 1-4 channels, out_ch 0, 2 and 4: every output
    equals native.decode's."""
    for channels in CHANNELS:
        streams = _edge_streams(entry, last, channels)
        for oc in OUT_CH:
            assert _mismatches(entry, streams, oc, monkeypatch) == [], (
                channels, oc)


@pytest.mark.parametrize("oc", OUT_CH)
def test_port_native_peeks_as_the_reference(oc):
    """The port's copy of the C runtime, which decodes every flagged stream
    on the host route, gives the reference package's pixels on every edge
    stream and on the seeded fuzz."""
    streams = [corpus.stream_end_stream(channels, last, pos)
               for last in corpus.END_OPS for channels in CHANNELS
               for pos in MARKER] + corpus.malformed_streams(FUZZ)
    for s in streams:
        want, got = native.decode(s, oc)[0], port_native.decode(s, oc)[0]
        assert (got is None) == (want is None)
        assert want is None or np.array_equal(got, want)


def test_edge_streams_reach_the_peek():
    """The edge streams test what they are meant to: the marker bytes that
    set the last pixel's alpha are the one the peek lands on in a color
    stream (byte 0 after a whole op, 3 after ``cut_rgba``, 1 after
    ``cut_luma``) and the alpha operand of a cut RGBA op; a mono stream
    has no peek."""
    readers = {(last, True): {0} for last in corpus.END_OPS}
    readers.update({(last, False): set() for last in corpus.END_OPS})
    readers[("cut_rgba", True)] = {2, 3}
    readers[("cut_luma", True)] = {1}
    readers[("cut_rgba", False)] = {1}
    for last in corpus.END_OPS:
        for channels in CHANNELS:
            clean = native.decode(
                corpus.stream_end_stream(channels, last, None), 4)[0]
            moved = {pos for pos in MARKER if native.decode(
                corpus.stream_end_stream(channels, last, pos), 4)[0][-1]
                != clean[-1]}
            assert moved == readers[(last, channels >= 3)], (last, channels)


@pytest.mark.parametrize("entry", ENTRIES[:4])
def test_rgb_repro_reads_alpha_from_the_marker(entry, monkeypatch):
    """The RGB repro (fault F1, ROADMAP.md Queue 3): native.decode gives
    alpha 255, 249, 249, 249 at out_ch 4. K1's noalpha mode did not flag the
    stream, so the port left alpha at 255; the first differing byte was 7
    (the second pixel's alpha)."""
    streams = [RGB_REPRO, RGB_REPRO]
    want = native.decode(RGB_REPRO, 4)[0]
    assert want[3::4].tolist() == [255, 249, 249, 249]
    for got in _decode(entry, streams, 4, monkeypatch):
        assert np.array_equal(got, want)


def test_rgb_repro_through_k10(monkeypatch):
    """With SEQOIA_REF_CUDA=1 the flagged RGB repro decodes through K10's
    plain walk, which peeks as the reference does."""
    monkeypatch.setenv("SEQOIA_REF_CUDA", "1")
    got = st.decode(RGB_REPRO, 4, device="cpu")[0]
    assert got[3::4].tolist() == [255, 249, 249, 249]


@pytest.mark.parametrize("oc", OUT_CH)
def test_rgba_shardmap_repro(oc):
    """The RGBA repro (fault F2): a 64x64 RGBA image, its marker's first
    byte 0x6A. The shard form staged its last row without the marker, so
    at out_ch 0 and 4 the last pixel's alpha was 60 where native.decode
    gives 54, first differing byte 16383; out_ch 2 falls back to
    decode_large."""
    img = (np.random.default_rng(3).integers(0, 4, 64 * 64 * 4)
           * 60).astype(np.uint8)
    s = bytearray(native.encode(img, 64, 64, 4, 0, 0))
    s[-8] = 0x6A
    want = native.decode(bytes(s), oc)[0]
    got = tiled.decode_large_shardmap(bytes(s), oc, n_shards=4,
                                      device="cpu")[0]
    assert np.array_equal(got, want)
    assert want[-1] == 54
    assert want.size - 1 == (16383 if oc != 2 else 8191)


def test_rgb_body_modifier_shardmap_repro():
    """Fault F3: an RGB stream with an alpha modifier after an op of its
    body (the RGB repro with 0x6A after its RGB op and a clean marker).
    ``native.scan_chunks`` consumes the modifier with its op, K1's noalpha
    mode flags the row, and the shard form dropped that flag: alpha 255
    where native.decode gives 249, first differing byte 3."""
    s = (RGB_REPRO[:19] + bytes([0x6A]) + RGB_REPRO[19:20]
         + corpus.end_marker(None))
    want = native.decode(s, 4)[0]
    assert want[3::4].tolist() == [249] * 4
    got = tiled.decode_large_shardmap(s, 4, n_shards=4, device="cpu")[0]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", (3, 4))
def test_jax_reference_ignores_the_peek(channels):
    """A fault of the JAX reference (ROADMAP.md Queue 3), recorded, not
    followed: on the CPU ``seqoia_tpu.decode`` leaves alpha at 255 on the
    RGB repro, and on the same stream with 4 channels, where native.decode
    (and the port) read the marker's alpha modifier."""
    s = RGB_REPRO[:12] + bytes([channels]) + RGB_REPRO[13:]
    want = native.decode(s, 4)[0]
    assert want[3::4].tolist() == [255, 249, 249, 249]
    assert np.array_equal(st.decode(s, 4, device="cpu")[0], want)
    jax_px, _ = sq.decode(s, 4)
    assert np.asarray(jax_px)[3::4].tolist() == [255] * 4


@pytest.mark.parametrize("entry", ENTRIES[:5])
@pytest.mark.parametrize("channels", (1, 2))
def test_mono_ignores_the_marker(entry, channels, monkeypatch):
    """A mono stream has no alpha peek: an alpha-range byte anywhere in its
    marker leaves every entry point's pixels as with a clean marker."""
    clean = corpus.stream_end_stream(channels, "rgb", None,
                                     icon=entry != "corpus_plain")
    streams = [corpus.stream_end_stream(channels, "rgb", pos,
                                        icon=entry != "corpus_plain")
               for pos in MARKER]
    for oc in OUT_CH:
        want = native.decode(clean, oc)[0]
        for got in _decode(entry, streams, oc, monkeypatch):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("entry", ENTRIES[:5])
def test_qoi_ignores_the_marker(entry, monkeypatch):
    """A ``.qoi`` stream has no alpha peek either: its marker's bytes are
    never read, on the card's fixpoint path as on the host's."""
    rng = np.random.default_rng(5)
    size = 16 if entry != "corpus_plain" else 17
    px = corpus._smooth(rng, size * 16, 4)
    clean = native.encode(px, size, 16, 4, 0, 1)
    streams = [clean[:-8] + corpus.end_marker(pos) for pos in MARKER]
    for oc in OUT_CH:
        want = native.decode(clean, oc)[0]
        for got in _decode(entry, streams, oc, monkeypatch):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("entry", ENTRIES)
def test_malformed_stream_fuzz(entry, monkeypatch):
    """A seeded fuzz (``corpus.malformed_streams``: body bytes overwritten,
    bodies cut short, marker bytes overwritten) of FUZZ streams through the
    entry point, out_ch 0, 2 and 4 in turn: 0 mismatches against
    native.decode. ``ref_cuda`` sends the streams K1 flags to K10."""
    streams = corpus.malformed_streams(FUZZ)
    bad = []
    for k, oc in enumerate(OUT_CH):
        part = streams[k::3]
        bad += [(oc, i) for i in _mismatches(entry, part, oc, monkeypatch)]
    assert bad == []
