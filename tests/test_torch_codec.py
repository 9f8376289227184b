"""The port's codec end to end on the CPU (the kernels' plain versions):
byte-exact against the JAX package (seqoia_tpu on the CPU), the native
oracle and, where it is mounted, the upstream reference probe.
"""

import struct

import numpy as np
import pytest

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from conftest import KINDS, gen_pixels
from seqoia_tpu import native, spec

_SHAPES = [(37, 29), (61, 13)]


def _stride(ch):
    return (1 if ch < 3 else 3) + (1 - (ch & 1))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_encode_matches_jax_and_native(ch):
    rng = np.random.default_rng(300 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        d = st.SqoaDesc(w, h, ch, i % 2, 0)
        ours = st.encode(pix, d, device="cpu")
        assert ours == native.encode(pix, w, h, ch, d.colorspace, 0), kind
        assert ours == sq.encode(pix, sq.SqoaDesc(w, h, ch, i % 2, 0)), kind


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_decode_matches_jax_and_native(ch):
    rng = np.random.default_rng(400 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        stream = native.encode(gen_pixels(rng, w * h, _stride(ch), kind),
                               w, h, ch, 0, 0)
        for fch in (0, 1, 2, 3, 4):
            ours, desc = st.decode(stream, fch, device="cpu")
            want, wdesc = native.decode(stream, fch)
            assert np.array_equal(ours, want), (kind, fch)
            assert (desc.width, desc.height, desc.channels, desc.colorspace,
                    desc.qoi_compat) == wdesc
            if i == 0:  # the JAX path compiles per shape and channel count
                jax_px, _ = sq.decode(stream, fch)
                assert np.array_equal(ours, jax_px), (kind, fch)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_codec_matches_reference_probe(ch, refprobe):
    rng = np.random.default_rng(500 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        stream = st.encode(pix, st.SqoaDesc(w, h, ch, 0, 0), device="cpu")
        assert stream == refprobe.encode(pix, w, h, ch), kind
        for fch in (0, 1, 2, 3, 4):
            ours, _ = st.decode(stream, fch, device="cpu")
            want, _ = refprobe.decode(stream, fch)
            assert np.array_equal(ours, want), (kind, fch)


def test_large_runs_and_odd_sizes():
    """Runs past 512 px (BIGRUN chains) and a stream whose pixel slots
    are far from a power of two."""
    rng = np.random.default_rng(9)
    for ch in (1, 2, 3, 4):
        w, h = 181, 23
        pix = gen_pixels(rng, w * h, _stride(ch), "long_runs")
        stream = st.encode(pix, st.SqoaDesc(w, h, ch, 0, 0), device="cpu")
        assert stream == native.encode(pix, w, h, ch, 0, 0)
        out, _ = st.decode(stream, 0, device="cpu")
        assert np.array_equal(out, pix)


def test_truncated_stream_fills_with_last_pixel():
    """A stream cut short is not an error: the pixels it does not reach
    take the last decoded value, as in the reference (seqoia.h:722-726)."""
    rng = np.random.default_rng(10)
    w, h = 64, 64
    stream = native.encode(gen_pixels(rng, w * h, 4, "noise"), w, h, 4, 0, 0)
    cut = stream[: len(stream) // 3] + bytes(8)
    ours, _ = st.decode(cut, 0, device="cpu")
    want, _ = native.decode(cut, 0)
    assert np.array_equal(ours, want)


def test_ref_stream_goes_to_the_host_decoder():
    """OP_REF (tags 0x00-0x5f) teleports the decoder's cursor: the card
    path flags the stream and the native decoder decodes it."""
    rng = np.random.default_rng(12)
    w, h = 16, 16
    stream = bytearray(native.encode(
        gen_pixels(rng, w * h, 3, "noise"), w, h, 3, 0, 0))
    assert stream[15 + 4 * 20] == 0xFE  # noise: RGB ops of 4 bytes each
    stream[15 + 4 * 20] = 0x0F          # REF: replay 15 bytes back
    stream = bytes(stream)
    want, wdesc = native.decode(stream, 0)
    assert want is not None
    ours, desc = st.decode(stream, 0, device="cpu")
    assert np.array_equal(ours, want)
    assert desc.width == w and desc.channels == 3


def test_qoi_compat_is_not_ported():
    """Mono QOI-compat, once the part of .qoi not ported (a decoder-only
    quirk; the encoder refuses mono compat): the port decodes it on the
    card path, equal to the native codec at channels 0-4, and its encoder
    still refuses it."""
    mono_qoi = (b"qoif" + struct.pack(">IIBB", 4, 1, 1, 0) + bytes([0xC3])
                + spec.PADDING)
    for channels in range(5):
        want, wdesc = native.decode(mono_qoi, channels)
        assert want is not None and len(want) == 4 * max(channels, 1)
        got, desc = st.decode(mono_qoi, channels, device="cpu")
        assert np.array_equal(got, want), channels
        assert (desc.width, desc.height, desc.channels, desc.colorspace,
                desc.qoi_compat) == wdesc
    assert st.encode(np.zeros(16, np.uint8), st.SqoaDesc(4, 4, 1, 0, 1),
                     device="cpu") is None


def test_invalid_inputs():
    assert st.decode(b"not an image at all", device="cpu") == (None, None)
    stream = native.encode(np.zeros(12, np.uint8), 2, 2, 3, 0, 0)
    assert st.decode(stream, 5, device="cpu") == (None, None)
    assert st.encode(np.zeros(12, np.uint8), st.SqoaDesc(0, 2, 3),
                     device="cpu") is None
    with pytest.raises(ValueError):
        st.decode(stream, backend="tpu", device="cpu")


def test_read_write_roundtrip(tmp_path):
    rng = np.random.default_rng(13)
    pix = gen_pixels(rng, 30 * 20, 4, "luma")
    desc = st.SqoaDesc(30, 20, 4, 0, 0)
    path = str(tmp_path / "img.sqoa")
    n = st.write(path, pix, desc, device="cpu")
    assert n == len(native.encode(pix, 30, 20, 4, 0, 0))
    got, gdesc = st.read(path, device="cpu")
    assert np.array_equal(got, pix) and gdesc.width == 30
    native_got, _ = st.read(path, backend="native")
    assert np.array_equal(native_got, pix)

    assert st.read(str(tmp_path / "missing"), device="cpu") == (None, None)
    with pytest.raises(OSError):
        st.read(str(tmp_path / "missing"), strict=True, device="cpu")
    bad = tmp_path / "bad.sqoa"
    bad.write_bytes(b"garbage" * 4)
    with pytest.raises(ValueError):
        st.read(str(bad), strict=True, device="cpu")
    assert st.write(str(tmp_path / "no" / "dir.sqoa"), pix, desc,
                    device="cpu") == 0
