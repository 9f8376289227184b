"""The large-image path of the port against the JAX package and the native
oracle: ``encode_large``, ``decode_large`` and both shard forms.

The port runs with ``device="cpu"`` (the kernels' plain versions); the JAX
functions run on the 8 virtual CPU devices conftest sets up, as
tests/test_sharding.py runs them. Same pixels, made from a seed with numpy,
the kinds and sizes of tests/test_sharding.py; streams and pixels are
compared exactly (tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from conftest import gen_pixels
from seqoia_tpu import native
from seqoia_tpu.parallel import tiled as jtiled
from seqoia_tpu.parallel.mesh import default_mesh
from seqoia_tpu_torch.parallel import tiled

# one thread per process: the suite runs several workers, and the plain
# versions' many small tensor ops only contend when each takes every core
torch.set_num_threads(1)


def _mesh(n=8):
    return default_mesh(jax.devices()[:n], axis="s")


def _rng(*key):
    return np.random.default_rng(abs(hash(key)) % 2**31)


def _stride(ch):
    return (1 if ch < 3 else 3) + (1 - (ch & 1))


@pytest.mark.parametrize("kind,ch", [
    ("luma", 3), ("long_runs", 3), ("noise", 3), ("sparse_delta", 4),
    ("luma", 1), ("alpha_churn", 2)])
def test_encode_large_parity(kind, ch):
    w, h = 512, 96
    pix = gen_pixels(np.random.default_rng(len(kind) + ch), w * h,
                     _stride(ch), kind)
    ours = st.encode_large(pix, st.SqoaDesc(w, h, ch), device="cpu")
    assert ours == native.encode(pix, w, h, ch, 0, 0)
    if ch == 3:  # the kinds tests/test_sharding.py runs through the JAX path
        assert ours == jtiled.encode_large(pix, sq.SqoaDesc(w, h, ch), _mesh())


@pytest.mark.parametrize("n", [1, 5000, 32768, 70001])
def test_encode_large_sizes_off_the_tile(n):
    pix = gen_pixels(np.random.default_rng(n), n, 3, "sparse_delta")
    ours = st.encode_large(pix, st.SqoaDesc(n, 1, 3), device="cpu")
    assert ours == native.encode(pix, n, 1, 3, 0, 0)


@pytest.mark.parametrize("kind", ["luma", "palette"])
def test_decode_large_parity(kind):
    w, h = 384, 128
    pix = gen_pixels(np.random.default_rng(len(kind)), w * h, 3, kind)
    stream = native.encode(pix, w, h, 3, 0, 0)
    for fch in (0, 4):
        ours, desc = st.decode_large(stream, fch, device="cpu")
        oracle, _ = native.decode(stream, fch)
        theirs, _ = jtiled.decode_large(stream, fch, _mesh())
        assert np.array_equal(ours, oracle)
        assert np.array_equal(ours, np.asarray(theirs))
        assert (desc.width, desc.height, desc.channels) == (w, h, 3)


@pytest.mark.parametrize("ch,fch", [(4, 0), (4, 3), (3, 1), (1, 0), (1, 3),
                                    (2, 0), (2, 4)])
def test_decode_large_modes_and_forced_channels(ch, fch):
    w, h = 200, 150
    pix = gen_pixels(np.random.default_rng(10 * ch + fch), w * h, _stride(ch),
                     "alpha_churn" if ch in (2, 4) else "luma")
    stream = native.encode(pix, w, h, ch, 0, 0)
    ours, desc = st.decode_large(stream, fch, device="cpu")
    oracle, _ = native.decode(stream, fch)
    assert np.array_equal(ours, oracle)
    assert desc.channels == ch


def _striped(rng, n):
    """tests/test_sharding.py's shard-map image: flat, colored and noisy
    stripes and one run that crosses two shard boundaries."""
    pix = np.zeros((n, 3), np.uint8)
    blocks = (np.arange(n) // 700) % 3
    pix[blocks == 1] = (9, 7, 5)
    pix[blocks == 2] = rng.integers(0, 256, (int((blocks == 2).sum()), 3))
    pix[60000:140000] = (3, 3, 3)
    return pix.ravel()


def test_encode_large_shardmap_parity_and_invariance():
    n = 8 * 32768 + 1234
    pix = _striped(np.random.default_rng(5), n)
    oracle = native.encode(pix, n, 1, 3, 0, 0)
    desc = st.SqoaDesc(n, 1, 3)
    for shards in (2, 8):
        assert st.encode_large_shardmap(pix, desc, n_shards=shards,
                                        device="cpu") == oracle
    assert st.encode_large(pix, desc, device="cpu") == oracle
    assert jtiled.encode_large_shardmap(pix, sq.SqoaDesc(n, 1, 3),
                                        _mesh(2)) == oracle


@pytest.mark.parametrize("ch,kind", [(4, "alpha_churn"), (1, "long_runs"),
                                     (2, "sparse_delta")])
def test_encode_large_shardmap_modes(ch, kind):
    """Mono and alpha sources, with shards past the image's end (8 shards of
    32768 pixels over a 49152-pixel image)."""
    w, h = 512, 96
    pix = gen_pixels(np.random.default_rng(ch), w * h, _stride(ch), kind)
    oracle = native.encode(pix, w, h, ch, 0, 0)
    for shards in (1, 2, 8):
        assert st.encode_large_shardmap(pix, st.SqoaDesc(w, h, ch),
                                        n_shards=shards,
                                        device="cpu") == oracle


@pytest.mark.parametrize("w,h,ch", [(16384, 3, 3), (4096, 9, 1)])
def test_encode_large_shardmap_flat_shards(w, h, ch):
    """One color over the whole image: every shard after the first holds no
    change, so its trailing run must count the run carried into it (the
    plain K3 once reported -1 there, not the carried anchor)."""
    pix = np.full(w * h * _stride(ch), 5, np.uint8)
    oracle = native.encode(pix, w, h, ch, 0, 0)
    for shards in (2, 4):
        assert st.encode_large_shardmap(pix, st.SqoaDesc(w, h, ch),
                                        n_shards=shards,
                                        device="cpu") == oracle
    assert jtiled.encode_large_shardmap(pix, sq.SqoaDesc(w, h, ch),
                                        _mesh(4)) == oracle


@pytest.mark.parametrize("kind,ch", [
    ("luma", 3), ("long_runs", 3), ("alpha_churn", 4), ("sparse_delta", 4),
    ("luma", 1), ("noise", 2)])
def test_decode_large_shardmap_parity(kind, ch):
    w, h = 512, 96
    pix = gen_pixels(np.random.default_rng(len(kind) + ch), w * h,
                     _stride(ch), kind)
    stream = native.encode(pix, w, h, ch, 0, 0)
    for fch in (0, 4):
        oracle, _ = native.decode(stream, fch)
        for shards in (2, 8):
            ours, desc = st.decode_large_shardmap(stream, fch,
                                                  n_shards=shards,
                                                  device="cpu")
            assert np.array_equal(ours, oracle), (kind, ch, fch, shards)
            assert desc.width == w
    theirs, _ = jtiled.decode_large_shardmap(stream, 0, _mesh())
    assert np.array_equal(oracle := native.decode(stream, 0)[0],
                          np.asarray(theirs))
    assert np.array_equal(
        st.decode_large_shardmap(stream, 0, n_shards=8, device="cpu")[0],
        oracle)


def test_decode_large_shardmap_gray_of_color_and_ref():
    """A color stream forced to gray cannot chain its boundary pixels and a
    REF stream cannot be cut: both take the sequential paths."""
    w, h = 300, 120
    pix = gen_pixels(np.random.default_rng(3), w * h, 3, "luma")
    stream = native.encode(pix, w, h, 3, 0, 0)
    ours, _ = st.decode_large_shardmap(stream, 1, n_shards=4, device="cpu")
    assert np.array_equal(ours, native.decode(stream, 1)[0])
    ref = bytearray(stream)
    ref[15] = 0x05
    for fn in (st.decode_large, st.decode_large_shardmap):
        ours, _ = fn(bytes(ref), 0, device="cpu")
        oracle, _ = native.decode(bytes(ref), 0)
        assert (ours is None) == (oracle is None)
        if oracle is not None:
            assert np.array_equal(ours, oracle)


def test_qoi_goes_to_the_native_codec(monkeypatch):
    calls = []
    pnative = tiled.native
    enc, dec = pnative.encode, pnative.decode
    monkeypatch.setattr(pnative, "encode",
                        lambda *a: calls.append("encode") or enc(*a))
    monkeypatch.setattr(pnative, "decode",
                        lambda *a: calls.append("decode") or dec(*a))
    pix = gen_pixels(np.random.default_rng(5), 64 * 64, 3, "palette")
    desc = st.SqoaDesc(64, 64, 3, 0, 1)
    oracle = native.encode(pix, 64, 64, 3, 0, 1)
    assert st.encode_large(pix, desc, device="cpu") == oracle
    assert st.encode_large_shardmap(pix, desc, device="cpu") == oracle
    for fn in (st.decode_large, st.decode_large_shardmap):
        ours, d = fn(oracle, 0, device="cpu")
        assert np.array_equal(ours, pix) and d.qoi_compat == 1
    assert calls == ["encode", "encode", "decode", "decode"]


def test_invalid_arguments():
    assert st.encode_large(None, st.SqoaDesc(4, 4, 3), device="cpu") is None
    assert st.encode_large(np.zeros(48, np.uint8), st.SqoaDesc(0, 4, 3),
                           device="cpu") is None
    assert st.decode_large(b"short", device="cpu") == (None, None)
    assert st.decode_large_shardmap(b"x" * 40, device="cpu") == (None, None)
    stream = native.encode(np.zeros(48, np.uint8), 4, 4, 3, 0, 0)
    assert st.decode_large(stream, 5, device="cpu") == (None, None)


def test_sizes_past_int32_raise(monkeypatch):
    """Offsets on the card are int32: a size past the limit raises instead
    of wrapping. (No test can hold a 2 GiB stream: the limit is lowered.)"""
    with pytest.raises(ValueError, match="int32"):
        tiled._require_int32("a buffer", 2**31)
    tiled._require_int32("a buffer", 2**31 - 1)
    pix = gen_pixels(np.random.default_rng(9), 40000, 3, "luma")
    desc = st.SqoaDesc(40000, 1, 3)
    stream = native.encode(pix, 40000, 1, 3, 0, 0)
    monkeypatch.setattr(tiled, "INT32_LIMIT", 140000)
    with pytest.raises(ValueError, match="limit 140000"):
        st.encode_large(pix, desc, device="cpu")
    # shards fit the lowered limit where the whole image does not
    assert st.encode_large_shardmap(pix, desc, n_shards=2,
                                    device="cpu") == stream
    monkeypatch.setattr(tiled, "INT32_LIMIT", 40000)
    assert len(stream) > 40000
    with pytest.raises(ValueError, match="limit 40000"):
        st.decode_large(stream, device="cpu")
    assert np.array_equal(
        st.decode_large_shardmap(stream, n_shards=4, device="cpu")[0], pix)
