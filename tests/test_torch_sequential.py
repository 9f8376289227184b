"""K9 (the sequential decoder of QOI-compat color ops): its plain version
against the JAX package's sequential compat decoder, and against the index
fixpoint.

``decode_jax.decode_stream_compat`` walks each stream's ops in a
``lax.scan`` (no Pallas kernel: its XLA form runs here on the CPU), vmapped
over a batch; the port takes the same buffers through the tokenizer and K5
(``decode_compat._ops``), K9 and K6 (``decode_compat._expand``), the path
an unsettled row takes. Integer codec: exact, tolerance 0.
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


def _jax_sequential(data, clen, npx, out_ch):
    fn = functools.partial(decode_jax.decode_stream_compat, colch=3,
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
    assert torch.equal(sequential.sequential_decode(x, x, torch.zeros(2)), x)
