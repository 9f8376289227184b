"""K9 (the sequential decoder of QOI-compat ops, color and mono): its plain
version against the JAX package's sequential compat decoder, and against
the index fixpoint.

``decode_jax.decode_stream_compat`` walks each stream's ops in a
``lax.scan`` (no Pallas kernel: its XLA form runs here on the CPU), vmapped
over a batch; the port takes the same buffers through the tokenizer and K5
(``decode_compat._ops``), K9 and K6 (``decode_compat._expand``), the path
an unsettled row takes, and every mono row. Mono streams come from
``utils.corpus.mono_qoi`` (seeded random ops, decoder-only: no encoder
writes mono .qoi) and from color .qoi encodes whose header says 1 or 2
channels. Integer codec: exact, tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KINDS, gen_pixels
from seqoia_tpu import native
from seqoia_tpu.codec import decode_jax
from seqoia_tpu_torch import convert
from seqoia_tpu_torch.codec import decode_compat
from seqoia_tpu_torch.ops import sequential
from seqoia_tpu_torch.utils import corpus

_M, _N_MAX = 8192, 2048


def _batch(streams):
    data = np.zeros((len(streams), _M), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    return data, np.array([len(s) - 8 for s in streams], np.int32)


def _jax_sequential(data, clen, npx, out_ch, colch=3):
    fn = functools.partial(decode_jax.decode_stream_compat, colch=colch,
                           out_ch=out_ch, n_max=_N_MAX, max_ops=_M)
    return np.asarray(jax.vmap(fn)(jnp.asarray(data), jnp.asarray(clen),
                                   jnp.asarray(npx)))


@pytest.mark.parametrize("ch", [3, 4])
def test_sequential_decoder_matches_jax(ch):
    """Every kind of tests/conftest.py as one batch of unequal rows, plus a
    stream cut short: the port's sequential decode against the JAX one,
    and both against the native decoder."""
    rng = np.random.default_rng(950 + ch)
    shapes = [(37, 29), (41, 13), (12, 40)]
    images = []
    for i, kind in enumerate(KINDS):
        w, h = shapes[i % 3]
        images.append((gen_pixels(rng, w * h, 3 + (1 - (ch & 1)), kind), w, h))
    streams = [native.encode(p, w, h, ch, 0, 1) for p, w, h in images]
    streams.append(streams[0][: len(streams[0]) // 2] + bytes(8))
    npx = np.array([w * h for _, w, h in images] + [37 * 29], np.int32)
    data, clen = _batch(streams)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen))
    px = sequential.sequential_decode(lo, hi, totals)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    ours = decode_compat._expand(lo & 255, px, valid, convert.tensor(npx), 3,
                                 ch, _N_MAX)
    theirs = _jax_sequential(data, clen, npx, ch)
    for r, (stream, n) in enumerate(zip(streams, npx)):
        want, _ = native.decode(stream)
        assert np.array_equal(ours[r, : n * ch].numpy(), want), r
        if r < len(images):  # the JAX decoder's fill past a cut may differ
            assert np.array_equal(ours[r].numpy(), theirs[r]), r


def test_sequential_values_match_the_fixpoint():
    """Per op, K9's running pixel equals the values of the settled index
    fixpoint, on photo crops whose fixpoint settles on the card."""
    rng = np.random.default_rng(960)
    streams = [native.encode(corpus._photo(rng, 40, 40).reshape(-1), 40, 40,
                             3, 0, 1) for _ in range(2)]
    data, clen = _batch(streams)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen))
    got = sequential.sequential_decode(lo, hi, totals)
    ops = (lo & 255, (lo >> 8) & 255, (lo >> 16) & 255, (lo >> 24) & 255,
           hi & 255)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    qslot = torch.where(valid & (ops[0] < 64), ops[0], -1).to(torch.int32)
    iv = torch.zeros_like(lo)
    for _ in range(200):
        iv, stable = decode_compat._resolve(ops, valid, qslot, totals, iv)
        if bool(stable.all()):
            break
    assert bool(stable.all())
    want, _ = decode_compat._op_values(ops, iv, valid)
    assert torch.equal(torch.where(valid, want, 0), got)


def test_sequential_decode_checks_its_arguments():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sequential.sequential_decode(x.long(), x, torch.zeros(2))
    with pytest.raises(ValueError, match="totals"):
        sequential.sequential_decode(x, x, torch.zeros(3))
    with pytest.raises(ValueError, match="device"):
        sequential.sequential_decode(x.to("meta"), x.to("meta"),
                                     torch.zeros(2))
    with pytest.raises(ValueError, match="colch"):
        sequential.sequential_decode(x, x, torch.zeros(2), colch=2)
    with pytest.raises(ValueError, match="hi"):
        sequential.sequential_decode(x, None, torch.zeros(2))
    assert torch.equal(sequential.sequential_decode(x, x, torch.zeros(2)), x)
    assert torch.equal(sequential.sequential_decode(x, None, torch.zeros(2),
                                                    colch=1), x)


def _mono_streams(rng, ch):
    """Mono .qoi rows of unequal lengths: generator streams (the default
    mix, one all INDEX and LUMA, one of long runs) and color .qoi encodes
    of conftest kinds with the header's channels byte set to ch."""
    streams = [corpus.mono_qoi(rng, 37, 29, ch),
               corpus.mono_qoi(rng, 41, 13, ch, (0.7, 0.3, 0, 0, 0)),
               corpus.mono_qoi(rng, 12, 40, ch, (0.2, 0.1, 0.6, 0.05, 0.05))]
    for kind in ("palette", "luma", "alpha_churn"):
        s = bytearray(native.encode(gen_pixels(rng, 30 * 20, 4, kind), 30, 20,
                                    4, 0, 1))
        s[12] = ch
        streams.append(bytes(s))
    return streams


def _mono_k9(streams, out_ch):
    """The port's mono route on _batch(streams): the mono tokenizer and K5,
    K9's mono step, K6 and _emit_pixels. Returns (pixels, K9's values)."""
    data, clen = _batch(streams)
    npx = np.array([int.from_bytes(s[4:8], "big")
                    * int.from_bytes(s[8:12], "big") for s in streams],
                   np.int32)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen), colch=1)
    assert hi is None
    px = sequential.sequential_decode(lo, None, totals, colch=1)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    out = decode_compat._expand(lo & 255, px, valid, convert.tensor(npx), 1,
                                out_ch, _N_MAX)
    return out, px, (data, clen, npx)


@pytest.mark.parametrize("ch", [1, 2])
def test_mono_sequential_decoder_matches_jax(ch):
    """K9's mono step (plain) against the JAX scan's mono step
    (decode_stream_compat(colch=1), vmapped) and the native decoder, at
    the header's own channel count and at 4."""
    streams = _mono_streams(np.random.default_rng(970 + ch), ch)
    for out_ch in (ch, 4):
        ours, _, (data, clen, npx) = _mono_k9(streams, out_ch)
        theirs = _jax_sequential(data, clen, npx, out_ch, colch=1)
        for r, (stream, n) in enumerate(zip(streams, npx)):
            want, _ = native.decode(stream, out_ch)
            assert np.array_equal(ours[r, : n * out_ch].numpy(), want), r
            assert np.array_equal(ours[r].numpy(), theirs[r]), r


def _op_stream(ops, w, h, ch=2):
    return (b"qoif" + w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([ch, 0]) + bytes(ops) + bytes(7) + b"\x01")


def _slot(g, a):
    return (g * 5 + a * 11) % 128


def _all_slots():
    """RGBA ops that fill all 128 slots (gray g at alpha 7 for each slot),
    then an INDEX read of every slot in a shuffled order."""
    want = {}
    ops = []
    for g in range(256):
        k = _slot(g, 7)
        if k not in want:
            want[k] = g
            ops += [0xFF, g, 7]
    assert len(want) == 128
    order = np.random.default_rng(5).permutation(128)
    ops += [int(k) for k in order]
    return ops, want, order


def test_mono_sequential_edge_rows():
    """K9's mono step at its edge rows: no op, one op, every one of the
    128 slots written and then read (an INDEX hit on a gray+alpha pixel:
    the hash is the reference's (g*5 + a*11) % 128 on gray in g, the value
    gray in byte 0), and a run to the row's end; against the JAX scan and
    the native decoder."""
    ops, want, order = _all_slots()
    streams = [
        _op_stream([], 5, 1),
        _op_stream([0xFF, 200, 17], 3, 1),
        _op_stream(ops, 2 * 128, 1),
        _op_stream([0xFE, 9, 0x85, 0xC0 + 61, 0xC0 + 40], 2 + 62 + 41, 1),
        _op_stream([0xFE, 9, 0xFD], 4, 1, ch=1),  # a run past the row's end
    ]
    ours, px, (data, clen, npx) = _mono_k9(streams, 2)
    theirs = _jax_sequential(data, clen, npx, 2, colch=1)
    for r, (stream, n) in enumerate(zip(streams, npx)):
        got = ours[r, : n * 2].numpy()
        assert np.array_equal(got, native.decode(stream, 2)[0]), r
        assert np.array_equal(ours[r].numpy(), theirs[r]), r
    # the reads of the slot-filling row: gray | alpha 7 << 24 from each slot
    n_fill = len(want)
    reads = px[2, n_fill: n_fill + 128].numpy().view(np.uint32)
    assert reads.tolist() == [want[int(k)] | 7 << 24 for k in order]
    assert ours[0, :10].tolist() == [0, 255] * 5  # no op: the initial pixel
