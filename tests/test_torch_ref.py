"""K10 (the sequential decoder of SQOA streams that hold OP_REF): its plain
version against the JAX package's ``decode_jax.decode_stream_ref`` (a
``lax.scan``, no Pallas kernel: jitted on the CPU here), and the port's
``decode`` route under ``SEQOIA_REF_CUDA=1`` against the native codec.

Streams: the hand-made ones of ``tests/test_jax_codec.py`` (replay,
mid-operand teleport, negative start, window spent, mono;
``utils/corpus.ref_hand_made``), 40 seeded encodes with REF-range bytes
injected (``utils/corpus.ref_injected``), and 32 streams of the port's REF
maker (``utils/corpus.ref_sqoa``). Integer codec: exact, tolerance 0,
``err`` included.

The kernel's design in plain form (``ref.ref_walk_plain``: chunks staged
into a ring, the descriptor walk, the byte walk, the records placed by
tiles) is held to ``ref_decode_plain``, pixels, ``err`` and the ops walked,
on the same streams and on ``utils/corpus.ref_edge_streams`` (REF windows
across a chunk edge, teleports onto, past and far across it, an
alpha-modifier peek at a window's end, nested REFs, a ladder of REFs that
walks the cursor back over chunks, the last pixel inside a run, dense
random REFs), with chunks of 64 and 128 bytes so that the edges occur at
test size, and at the kernel's own chunk; the edge streams also against
the JAX scan.
"""

import numpy as np
import pytest
import torch

import seqoia_tpu_torch as st
from seqoia_tpu.codec import decode_jax
from seqoia_tpu_torch import cli, native, spec
from seqoia_tpu_torch.ops import frontend, ref
from seqoia_tpu_torch.utils import corpus, trace

_M = 16384  # every stream padded to one buffer length: one jit a mode


def _maker_images(n=32, seed=3):
    """(flat pixels, w, h, channels) of small images: gray scans (with and
    without alpha), icons (RGBA and RGB) and photos, 48x40 to 64x64."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            img = corpus._mono_doc(rng, 64, 48)
        elif kind == 1:
            g = corpus._mono_doc(rng, 48, 40)
            a = np.full(g.shape[:2] + (1,), 255, np.uint8)
            a[rng.random(g.shape[:2]) < 0.05] = 200
            img = np.concatenate([g.reshape(g.shape[:2] + (1,)), a], -1)
        elif kind == 2:
            img = corpus._icon(rng, 64, 5, glow_w=0.6, glow_peak=0.5)
            if i % 8 == 6:
                img = np.ascontiguousarray(img[..., :3])
        else:
            img = corpus._photo(rng, 64, 48)
        img = img.reshape(img.shape[:2] + (-1,))
        out.append((img.reshape(-1), img.shape[1], img.shape[0],
                    img.shape[2]))
    return out


def _maker_streams(n=32, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for px, w, h, ch in _maker_images(n, seed):
        made = corpus.ref_sqoa(native.encode(px, w, h, ch, 0, 0), rng)
        assert made is not None, (w, h, ch)
        out.append((made, px, ch))
    return out


def _args(stream, channels):
    desc = spec.unpack_header(stream[:15] + bytes(8))
    colch = desc.col_channels
    out_ch = channels or colch + desc.has_alpha
    n = desc.n_pixels
    buf = np.zeros(_M, np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)
    n_max = 1 << (max(n, 4) - 1).bit_length()
    return buf, len(stream) - 8, n, colch, out_ch, n_max


def _both(stream, channels):
    """(plain K10's (pixels, err), the JAX scan's), as numpy."""
    buf, clen, n, colch, out_ch, n_max = _args(stream, channels)
    kw = dict(colch=colch, out_ch=out_ch, n_max=n_max)
    got, gerr, _ = ref.ref_decode(torch.from_numpy(buf), clen, n, **kw)
    want, werr = decode_jax.decode_stream_ref(buf, np.int32(clen),
                                              np.int32(n), **kw)
    return (got.numpy(), bool(gerr)), (np.asarray(want), bool(werr))


def _same(stream, channels):
    (got, gerr), (want, werr) = _both(stream, channels)
    assert gerr == werr, (stream.hex(), channels)
    assert np.array_equal(got, want), (stream.hex(), channels)
    return gerr


@pytest.mark.parametrize("name", list(corpus.ref_hand_made()))
def test_plain_matches_jax_on_hand_made_streams(name):
    stream = corpus.ref_hand_made()[name]
    for channels in range(5):
        (got, err), _ = _both(stream, channels)
        assert _same(stream, channels) == err == (name == "negative_start")
        # and the native codec: the same pixels, or its refusal
        want, _ = native.decode(stream, channels)
        assert (want is None) == err
        if want is not None:
            assert np.array_equal(got[: len(want)], want)


def test_plain_matches_jax_on_injected_streams():
    for i, stream in enumerate(corpus.ref_injected()):
        _same(stream, i % 5)


@pytest.mark.parametrize("part", range(4))
def test_plain_matches_jax_on_maker_streams(part):
    for made, _, _ in _maker_streams()[part::4]:
        for channels in range(5):
            assert not _same(made, channels)


def test_maker_splices_ref_ops():
    """Every maker stream carries REF ops that the native codec accepts;
    where every splice keeps the pixels (gray scans: runs and LUMA bytes
    repeat), the native decode gives the source image back."""
    kept = 0
    for made, px, ch in _maker_streams():
        buf = torch.from_numpy(np.frombuffer(made, np.uint8).copy())
        desc = spec.unpack_header(made[:15] + bytes(8))
        mode = ("mono" if desc.col_channels == 1 else
                ("alpha" if desc.has_alpha else "noalpha"))
        *_, has_ref = frontend.decode_front_compact(
            buf[None], torch.tensor([len(made) - 8], dtype=torch.int32),
            desc.n_pixels, mode=mode)
        assert bool(has_ref[0])
        got, _ = native.decode(made, 0)
        kept += np.array_equal(got, px)
    assert kept >= 8


def test_decode_routes_ref_streams_to_k10(monkeypatch):
    """SEQOIA_REF_CUDA=1: a stream K1 flags goes to K10 on the same device
    and never to the host codec; a REF that starts before the stream gives
    (None, None), as the native codec's refusal."""
    streams = (list(corpus.ref_hand_made().values()) + corpus.ref_injected(12)
               + [m for m, _, _ in _maker_streams(8)])
    want = {(s, c): native.decode(s, c) for s in streams for c in range(5)}

    def host(*a):
        raise AssertionError("a REF stream went to the host codec")
    monkeypatch.setattr(native, "decode", host)
    monkeypatch.setenv("SEQOIA_REF_CUDA", "1")
    n0 = trace.counters().get("kernels.launches.K10", 0)
    for (s, c), (wpx, wdesc) in want.items():
        got, desc = st.decode(s, c, device="cpu")
        assert (got is None) == (wpx is None), (s.hex(), c)
        if wpx is not None:
            assert np.array_equal(got, wpx), (s.hex(), c)
            assert (desc.width, desc.height, desc.channels) == wdesc[:3]
    # the CPU runs the plain version
    assert trace.counters().get("kernels.launches.K10", 0) == n0


def test_decode_sends_ref_streams_to_the_host_when_unset(monkeypatch):
    monkeypatch.delenv("SEQOIA_REF_CUDA", raising=False)
    calls = []
    decode = native.decode
    monkeypatch.setattr(native, "decode",
                        lambda *a: calls.append(1) or decode(*a))
    stream = corpus.ref_hand_made()["replay"]
    got, _ = st.decode(stream, 0, device="cpu")
    assert calls and np.array_equal(got, decode(stream, 0)[0])


def test_ref_past_the_last_pixel_follows_the_native_codec(monkeypatch):
    """A stream whose ops run past its pixels, the extra op a REF whose
    window starts before the stream: the reference never reads it (its loop
    ends at the last pixel) and decodes the image; the JAX scan runs to its
    power-of-two n_max and flags it. K10 stops at n_pixels, as the
    reference does."""
    hdr = spec.pack_header(spec.SqoaDesc(3, 1, 3, 0, 0))
    stream = hdr + bytes([0xFE, 1, 2, 3, 0xC1, 31]) + spec.PADDING
    want, _ = native.decode(stream, 0)
    assert want is not None
    (got, gerr), (_, werr) = _both(stream, 0)
    assert werr and not gerr  # the JAX scan's flag (ROADMAP, Queue 3)
    assert np.array_equal(got[: 3 * 3], want)
    monkeypatch.setenv("SEQOIA_REF_CUDA", "1")
    px, _ = st.decode(stream, 0, device="cpu")
    assert np.array_equal(px, want)


def test_wrapper_checks_its_arguments():
    buf = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError, match="colch"):
        ref.ref_decode(buf, 20, 4, colch=2, out_ch=3, n_max=4)
    with pytest.raises(ValueError, match="out_ch"):
        ref.ref_decode(buf, 20, 4, colch=3, out_ch=5, n_max=4)
    with pytest.raises(ValueError, match="n_max"):
        ref.ref_decode(buf, 20, 8, colch=3, out_ch=3, n_max=4)
    with pytest.raises(ValueError, match="uint8"):
        ref.ref_decode(buf.int(), 20, 4, colch=3, out_ch=3, n_max=4)
    with pytest.raises(ValueError, match="device"):
        ref.ref_decode(buf.to("meta"), 20, 4, colch=3, out_ch=3, n_max=4)


@pytest.mark.parametrize("ref_cuda", ["", "1"])
def test_fuzz_command_on_the_plain_versions(monkeypatch, capsys, ref_cuda):
    """`fuzz --cuda --device cpu`: the card path's decode (the kernels'
    plain versions) against the native codec, REF streams through K10 with
    SEQOIA_REF_CUDA=1 and through the host codec without."""
    monkeypatch.setenv("SEQOIA_REF_CUDA", ref_cuda)
    n0 = trace.counters().get("kernels.launches.K10", 0)
    assert cli.main(["fuzz", "200", "--cuda", "--device", "cpu"]) == 0
    assert "0 mismatches" in capsys.readouterr().out
    assert trace.counters().get("kernels.launches.K10", 0) == n0


def _walk_same(stream, channels, chunk):
    """The descriptor walk (at ``chunk`` bytes a chunk) against the op-by-op
    walk: pixels, err and the ops walked."""
    buf, clen, n, colch, out_ch, n_max = _args(stream, channels)
    kw = dict(colch=colch, out_ch=out_ch, n_max=n_max)
    data = torch.from_numpy(buf)
    want, werr, wops = ref.ref_decode_plain(data, clen, n, **kw)
    got, gerr, gops = ref.ref_walk_plain(data, clen, n, chunk=chunk, **kw)
    assert bool(gerr) == bool(werr), (stream.hex(), channels, chunk)
    assert int(gops) == int(wops), (stream.hex(), channels, chunk)
    assert torch.equal(got, want), (stream.hex(), channels, chunk)
    return bool(werr)


@pytest.mark.parametrize("chunk", [64, 128, ref.CHUNK])
def test_walk_matches_plain_on_hand_made_and_injected_streams(chunk):
    for name, stream in corpus.ref_hand_made().items():
        for channels in range(5):
            assert _walk_same(stream, channels, chunk) == (
                name == "negative_start")
    for i, stream in enumerate(corpus.ref_injected()):
        _walk_same(stream, i % 5, chunk)


@pytest.mark.parametrize("chunk", [64, ref.CHUNK])
@pytest.mark.parametrize("part", range(2))
def test_walk_matches_plain_on_maker_streams(part, chunk):
    for made, _, _ in _maker_streams()[part::2]:
        for channels in range(5):
            assert not _walk_same(made, channels, chunk)


_EDGE = corpus.ref_edge_streams(64)


@pytest.mark.parametrize("name", sorted(_EDGE))
def test_walk_matches_plain_and_jax_on_edge_streams(name):
    """The edge streams made for 64-byte chunks, walked at 64 bytes a chunk
    (their edges) and at 128: equal to the op-by-op walk, which equals the
    JAX scan (every stream decodes without err)."""
    stream = _EDGE[name]
    for channels in range(5):
        assert not _same(stream, channels)
        for chunk in (64, 128):
            assert not _walk_same(stream, channels, chunk)


@pytest.mark.parametrize("chunk", [128, ref.CHUNK])
def test_walk_matches_plain_on_edge_streams_at_their_chunk(chunk):
    for stream in corpus.ref_edge_streams(chunk).values():
        for channels in (0, 1, 4):
            assert not _walk_same(stream, channels, chunk)


def test_edge_streams_meet_their_cases():
    """Each edge stream does what its name says, at 64 bytes a chunk (the
    REFs the op-by-op walk meets, traced: tag position, window start and
    end, resume point, and whether a window was open)."""
    edge = 2 * 64

    def refs(stream):
        b, colch = list(stream), 3 if stream[12] >= 3 else 1
        last, clen = len(b) - 1, len(b) - 8
        n = spec.unpack_header(stream[:15] + bytes(8)).n_pixels
        pos, rend, res, t, out, peeks = 15, -1, 0, 0, [], []

        def fetch(p):
            return b[min(max(p, 0), last)]

        def nxt():
            nonlocal pos
            if pos == rend:
                pos = res + 1
                return fetch(pos)
            pos += 1
            return fetch(pos - 1)
        while t < n and pos < clen:
            inside, q, b1 = pos < rend, pos, nxt()
            if b1 < 0x60:
                res, rend = pos, pos - (b1 & 31)
                start = rend - 2 - (b1 >> 5)
                out.append((q, start, rend, res, inside))
                b1, pos = fetch(start), start + 1
            run = 0
            if b1 >= 0xFE:
                for _ in range(colch if b1 == 0xFE else colch + 1):
                    nxt()
            elif b1 & 0xC0 == 0x80:
                if colch == 3:
                    nxt()
            else:
                run = 511 if b1 == 0xFD else b1 & 63
            if colch == 3 and 0x60 <= fetch(pos) < 0x80:
                peeks.append(pos == rend)
                nxt()
            t += run + 1
        return out, peeks, t, n

    for colch in (3, 1):
        get = {k[:-2]: refs(s) for k, s in _EDGE.items()
               if k.endswith(f"_{colch}")}
        (q, start, rend, res, _), = get["straddle"][0]
        assert start < edge < rend
        assert get["resume_at_edge"][0][0][3] + 1 == edge
        assert get["resume_past_edge"][0][0][3] + 1 == edge + 1
        (q, start, rend, res, _), = get["far_teleport"][0]
        assert q == edge - 3 and rend < edge - 30 and res + 1 >= edge - 1
        assert any(r[4] for r in get["nested"][0])
        ladder = get["ladder"][0]
        depth = max(i for i, r in enumerate(ladder) if all(
            x[4] for x in ladder[1: i + 1]))
        assert depth >= 4 and ladder[depth][1] < edge - 64
        if colch == 3:
            for case in ("peek_at_end", "peek_at_end_mid"):
                assert any(get[case][1])
            assert get["peek_at_end"][0][0][2] == edge
        for case, run in (("run_end", 61), ("bigrun_end", 512)):
            out, _, t, n = get[case]
            assert not out and n < t < n + run


def test_descriptors_plain_fields():
    """The descriptor words of hand-picked ops: the next op's address, the
    slow flag, the op's pixels (a REF's: its tag), the keep mask and the
    byte-wise addend."""
    ops = [0xFE, 1, 2, 3, 0xFF, 4, 5, 6, 7, 0x65, 0xA3, 0x76, 0xC9, 0xFD,
           0x21, 0x70]
    words = ref.ref_descriptors_plain(
        torch.tensor(ops, dtype=torch.uint8), colch=3, chunk=64, stages=2,
        first=120, base=1024).tolist()

    def word(p):
        x, meta, add, keep = words[p]
        if meta & ref.SLOW:
            return (x - 1024) // 16, True, (meta >> 16) & 255, add, keep
        return (x - 1024) // 16, False, meta, keep, add
    # ring indices: (120 + p + the op's bytes) % 128
    assert word(0) == (124, False, 1, 0xFF000000, 0x030201)  # RGB
    assert word(4) == (2, False, 1, 0, 0x07060504 + (5 - 16 << 24)
                       & 0xFFFFFFFF)  # RGBA + modifier
    vg = 0x23 - 32
    assert word(10) == (4, False, 1, 0xFFFFFFFF,
                        (vg - 8 + 7) & 255 | (vg & 255) << 8
                        | ((vg - 8 + 6) & 255) << 16)  # LUMA, operand 0x76
    assert word(12) == (5, False, 10, 0xFFFFFFFF, 0)  # RUN of 10
    assert word(13) == (6, False, 512, 0xFFFFFFFF, 0)  # BIGRUN
    assert word(14) == (6, True, 0x21, 0, 0)  # REF: its own word, its tag
    words = ref.ref_descriptors_plain(
        torch.tensor([0xFF, 9, 200, 0x85], dtype=torch.uint8),
        colch=1).tolist()
    assert words[0][0] == 3 * 16 and words[0][3] == 0
    assert words[0][2] == 9 * 0x010101 | 200 << 24  # mono RGBA
    assert words[3][2] == (5 - 32 & 255) * 0x010101  # mono LUMA, no operand
