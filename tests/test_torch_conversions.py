"""K2's channel-converting epilogues (a gray source decoded to 4 or 3
channels, a colour source to 1 or 2) on the CPU, through their plain forms,
on each route that runs them: ``decode_stream_batched`` (at emit "u8" and
"words"), ``decode_stream_packed`` and the ``.qoi`` decode
(``decode_stream_compat_batched``: colour rows through the fixpoint, mono
rows through the sequential decoder). Each is held byte for byte to the
JAX package: its unfused ``decode_stream_batched`` (the XLA fill and
``_emit_pixels``, which run on the CPU) and its sequential ``.qoi`` decoder
(``decode_jax.decode_stream_compat``), zeros past ``n_pixels`` and the
"words" layout included, and each image to the native codec. No route
reaches K6 (``place_fill``); each counts its rows under ``codec.emit.rows``
and launches in the span ``codec.emit_pixels`` with the same attributes as
the emit it replaced."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import gen_pixels
from seqoia_tpu import native
from seqoia_tpu.codec import decode_jax
from seqoia_tpu.codec import decode_v2 as jax_decode_v2
from seqoia_tpu_torch.codec import decode_compat, decode_v2
from seqoia_tpu_torch.ops import engine
from seqoia_tpu_torch.utils import corpus, trace
from test_torch_packed_decode import N, gen, pack_rows

torch.set_num_threads(1)

# pair: (the source's channels, out_ch); the even sources carry alpha, so
# gray to 4 and colour to 2 keep it
PAIRS = {"gray_to_4": (2, 4), "gray_to_3": (1, 3), "colour_to_1": (3, 1),
         "colour_to_2": (4, 2)}
M, N_MAX = 8192, 2048
SHAPES = [(40, 30), (33, 17), (24, 25)]  # n_pixels below N_MAX: zeros after


def _stage(streams, m=M):
    data = np.zeros((len(streams), m), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    clen = np.array([len(s) - 8 for s in streams], np.int32)
    npx = np.array([int.from_bytes(s[4:8], "big") * int.from_bytes(s[8:12],
                                                                  "big")
                    for s in streams], np.int32)
    return data, clen, npx


def _same_rows(ours, theirs, streams, npx, out_ch):
    """Whole rows equal to the JAX package's, each image to the native
    codec's, zeros after."""
    assert ours.dtype == torch.uint8 and ours.shape == (len(streams),
                                                        N_MAX * out_ch)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    for r, (s, n) in enumerate(zip(streams, npx)):
        assert np.array_equal(ours[r, : n * out_ch].numpy(),
                              native.decode(s, out_ch)[0]), r
        assert not ours[r, n * out_ch:].any(), r


def _batched(ch, out_ch, rng):
    colch = 1 if ch < 3 else 3
    kinds = ["luma", "alpha_churn" if ch % 2 == 0 else "noise", "long_runs"]
    streams = [native.encode(gen_pixels(rng, w * h, ch, k), w, h,
                             ch, 0, 0) for (w, h), k in zip(SHAPES, kinds)]
    data, clen, npx = _stage(streams)
    kw = dict(colch=colch, out_ch=out_ch, n_max=N_MAX, src_alpha=ch % 2 == 0)
    ours, ref = decode_v2.decode_stream_batched(
        torch.from_numpy(data), torch.from_numpy(clen), torch.from_numpy(npx),
        **kw)
    words, _ = decode_v2.decode_stream_batched(
        torch.from_numpy(data), torch.from_numpy(clen), torch.from_numpy(npx),
        emit="words", **kw)
    args = (jnp.asarray(data), jnp.asarray(clen), jnp.asarray(npx))
    theirs, _ = jax_decode_v2.decode_stream_batched(*args, compat=False, **kw)
    their_words, _ = jax_decode_v2.decode_stream_batched(
        *args, compat=False, emit="words", **kw)
    assert not bool(ref.any())
    _same_rows(ours, theirs, streams, npx, out_ch)
    their_words = np.asarray(their_words)
    assert words.dtype == torch.int32 and their_words.dtype == np.int32
    assert np.array_equal(words.numpy(), their_words)
    return 2 * len(streams), N_MAX


def _packed(ch, out_ch, rng):
    """Nine 64x64 images in 4096-byte segments: one full row of eight and a
    second row with seven empty segments."""
    colch = 1 if ch < 3 else 3
    kinds = ["palette", "runs", "luma", "solid"] + (
        ["alpha_churn"] if ch % 2 == 0 else ["palette"])
    streams = [native.encode(gen(rng, kinds[i % 5], ch), 64, 64, ch,
                             0, 0) for i in range(9)]
    data, slens = pack_rows(streams, 4096)
    words, has_ref = decode_v2.decode_stream_packed(
        torch.from_numpy(data), torch.from_numpy(slens), colch=colch,
        out_ch=out_ch, seg=4096, seg_px=N, src_alpha=ch % 2 == 0)
    assert not bool(has_ref.any())
    assert words.dtype == torch.int32
    assert words.shape == (2, 8 * N * out_ch // 4)
    per_image = words.numpy().view(np.uint8).reshape(16, N * out_ch)[:9]
    one, clen, npx = _stage(streams, 4096)
    theirs, _ = jax_decode_v2.decode_stream_batched(
        jnp.asarray(one), jnp.asarray(clen), jnp.asarray(npx), colch=colch,
        compat=False, out_ch=out_ch, n_max=N, src_alpha=ch % 2 == 0)
    assert np.array_equal(per_image, np.asarray(theirs))
    for img, s in zip(per_image, streams):
        assert np.array_equal(img, native.decode(s, out_ch)[0])
    return 2, 8 * N


def _qoi(ch, out_ch, rng):
    """Colour .qoi encodes (the fixpoint's rows) or mono .qoi streams (the
    sequential decoder's)."""
    colch = 1 if ch < 3 else 3
    if colch == 1:
        streams = [corpus.mono_qoi(rng, w, h, ch) for w, h in SHAPES]
    else:
        kinds = ["palette", "luma", "alpha_churn" if ch == 4 else "noise"]
        streams = [native.encode(gen_pixels(rng, w * h, ch, k), w, h, ch, 0,
                                 1) for (w, h), k in zip(SHAPES, kinds)]
    data, clen, npx = _stage(streams)
    ours, _ = decode_compat.decode_stream_compat_batched(
        torch.from_numpy(data), torch.from_numpy(clen), torch.from_numpy(npx),
        colch=colch, out_ch=out_ch, n_max=N_MAX)
    fn = functools.partial(decode_jax.decode_stream_compat, colch=colch,
                           out_ch=out_ch, n_max=N_MAX, max_ops=M)
    theirs = jax.vmap(fn)(jnp.asarray(data), jnp.asarray(clen),
                          jnp.asarray(npx))
    _same_rows(ours, theirs, streams, npx, out_ch)
    return len(streams), N_MAX


ROUTES = {"batched": _batched, "packed": _packed, "qoi": _qoi}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_conversion_matches_jax(pair, route, monkeypatch):
    ch, out_ch = PAIRS[pair]
    monkeypatch.setattr(engine, "place_fill", None)  # no route reaches K6
    rng = np.random.default_rng(2700 + 10 * ch + out_ch + 100 * len(route))
    trace.enable()
    try:
        with trace.entry("test.conversion"):
            rows, n_max = ROUTES[route](ch, out_ch, rng)
    finally:
        trace.disable()
    call = trace.calls(1)[0]
    assert call["counters"]["codec.emit.rows"] == rows
    spans = [s for s in call["spans"] if s["name"] == "codec.emit_pixels"]
    assert spans and sum(s["attrs"]["rows"] for s in spans) == rows
    assert all(s["attrs"] == {"rows": s["attrs"]["rows"],
                              "colch": 1 if ch < 3 else 3, "out_ch": out_ch,
                              "n_max": n_max} for s in spans)
