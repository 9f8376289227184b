"""SQOA (non-compat) stream decode on the card.

Port of the fused branch of ``seqoia_tpu/codec/decode_v2.py``
(``decode_stream_batched``, ``decode_stream``): K1 turns the bytes into the
compacted op stream, K2 places it and emits the pixels through one of the
decode epilogues below. The shapes K2 cannot emit directly (a color
source decoded to 1/2 channels, a mono source to 3/4) go K1 -> K6 ->
``_emit_pixels``; the JAX package sends mono sources with forced 3/4
channels through its unfused front instead, which gives the same pixels
(K1 is a drop-in for that front's compacted output).

The compat (``.qoi``) decode tokenizes with ``_tokenize`` below, the JAX
package's unfused tokenizer in its compat color and mono forms (K8
composes the countdown maps).
"""

from __future__ import annotations

import torch

from .. import spec
from ..ops import engine, frontend, scan_ops
from ..ops._plain import to_i32
from ..utils import trace

_INIT_PACKED = -16777216  # (0, 0, 0, 255): the decoder's initial pixel


def _token_lengths(b, colch: int = 3):
    """QOI-compat token length per byte position, assuming a token starts
    there. Color: INDEX, DIFF and RUN 1 byte, LUMA 2, RGB 4, RGBA 5. Mono
    (colch 1): RGB 2, RGBA 3, any other tag 1 (a tag below 128 is an INDEX
    of the 128-slot table)."""
    if colch == 1:
        lens = torch.where(b == spec.OP_RGB, 2, 1)
        return torch.where(b == spec.OP_RGBA, 3, lens)
    lens = 1 + ((b & spec.MASK_2) == spec.OP_LUMA).to(torch.int32)
    lens = torch.where(b == spec.OP_RGB, 4, lens)
    lens = torch.where(b == spec.OP_RGBA, 5, lens)
    return torch.where(b < spec.QOI_INDEX_SIZE, 1, lens)


def _tokenize(b, chunks_len, colch: int = 3):
    """Token-start mask of (B, M) int32 QOI-compat streams (tokens start
    after the header; chunks_len (B, 1) ends them)."""
    state = scan_ops.tokenizer_states(_token_lengths(b, colch),
                                      spec.HEADER_SIZE)
    idx = torch.arange(b.shape[-1], device=b.device)
    return (state == 0) & (idx >= spec.HEADER_SIZE) & (idx < chunks_len)


def _dec4(filled, t, scal):
    return to_i32(torch.where(t < scal[:, :1], filled[0], 0))


def _dec3(filled, t, scal):
    words = _dec4(filled, t, scal)
    bsz, n = words.shape
    rgb = words.view(torch.uint8).reshape(bsz, n, 4)[:, :, :3]
    return rgb.reshape(bsz, n * 3).view(torch.int32)


def _mono1(filled, t, scal):
    return torch.where(t < scal[:, :1], filled[0] & 255, 0).to(torch.uint8)


def _mono2(filled, t, scal):
    f = filled[0]
    v = (f & 255) | (((f >> 24) & 255) << 8)
    return torch.where(t < scal[:, :1], v, 0).to(torch.int32).to(torch.uint16)


def _dec_epilogue(out_ch: int) -> engine.Epilogue:
    """Color emission in K2: out_ch=4 writes the packed words (their
    little-endian bytes are the RGBA stream), out_ch=3 the int32 words of
    the interleaved RGB stream (the alpha byte dropped). Both zero the
    pixels past n_pixels (the scalar)."""
    if out_ch == 4:
        return engine.Epilogue(engine.EPI_DEC4, torch.int32, _dec4)
    return engine.Epilogue(engine.EPI_DEC3, torch.int32, _dec3, (3, 4))


def _dec_epilogue_mono(out_ch: int) -> engine.Epilogue:
    """Mono emission in K2 (gray in packed byte 0, alpha in byte 3):
    out_ch=1 uint8 gray, out_ch=2 uint16 gray | alpha << 8."""
    if out_ch == 1:
        return engine.Epilogue(engine.EPI_MONO1, torch.uint8, _mono1)
    return engine.Epilogue(engine.EPI_MONO2, torch.uint16, _mono2)


def _emit_pixels(filled, n_pixels, colch: int, out_ch: int, n_max: int):
    """Filled packed pixels (B, n_max) int32 -> flat interleaved uint8
    (B, n_max * out_ch), zero past n_pixels. Mono payloads carry gray in
    byte 0 (K1's mono layout), replicated for out_ch 3/4. Counts its rows
    under ``codec.emit.rows`` and runs in the span ``codec.emit_pixels``."""
    rows = filled.shape[0]
    trace.count("codec.emit.rows", rows)
    with trace.span("codec.emit_pixels", rows=rows, colch=colch,
                    out_ch=out_ch, n_max=n_max):
        f = filled.long()
        r, g, b, a = ((f & 255), (f >> 8) & 255, (f >> 16) & 255,
                      (f >> 24) & 255)
        if colch == 3:
            cols = [r, g, b] if out_ch >= 3 else [g]
        else:
            cols = [r, r, r] if out_ch >= 3 else [r]
        if out_ch in (2, 4):
            cols.append(a)
        out = torch.stack(cols[:out_ch], dim=2)
        t = torch.arange(n_max, device=f.device)[None, :, None]
        out = torch.where(t < n_pixels.long()[:, None, None], out, 0)
        return out.to(torch.uint8).reshape(rows, n_max * out_ch)


def _maybe_words(u8_flat, emit: str):
    """Flat uint8 pixels -> int32 words when emit="words"."""
    if emit != "words":
        return u8_flat
    return u8_flat.view(torch.int32)


def decode_stream_batched(data, chunks_len, n_pixels, *, colch: int,
                          out_ch: int, n_max: int, emit: str = "u8",
                          src_alpha: bool = True):
    """Decode a batch of SQOA (non-compat) streams.

    data: (B, M) uint8; chunks_len (stream length less the end marker) and
    n_pixels: (B,) int32; n_max: pixel slots per row (>= n_pixels, a
    multiple of 4). Returns (pixels, has_ref (B,) bool): pixels are flat
    interleaved uint8 (B, n_max * out_ch), or with emit="words" an array
    whose little-endian bytes are that stream (int32 (B, n_max * out_ch //
    4) for color, uint8/uint16 (B, n_max) for mono sources at 1/2
    channels). Rows with has_ref set need the host decoder."""
    if emit not in ("u8", "words"):
        raise ValueError(f"emit {emit!r}")
    if colch not in (1, 3) or out_ch not in (1, 2, 3, 4):
        raise ValueError("colch must be 1 or 3 and out_ch 1 to 4")
    bsz = data.shape[0]
    mode = "mono" if colch == 1 else ("alpha" if src_alpha else "noalpha")
    keys, pays, totals, ref = frontend.decode_front_compact(
        data, chunks_len, n_max, mode=mode)
    npx = n_pixels.to(device=data.device, dtype=torch.int32)[:, None]
    init = (_INIT_PACKED,)
    if colch == 1 and out_ch in (1, 2):
        out = engine.place_emit(keys, [pays], totals, npx, n_max, init,
                                _dec_epilogue_mono(out_ch))
        if emit == "words" or out_ch == 1:
            return out, ref != 0
        return out.view(torch.uint8).reshape(bsz, n_max * 2), ref != 0
    if colch == 3 and out_ch in (3, 4):
        words = engine.place_emit(keys, [pays], totals, npx, n_max, init,
                                  _dec_epilogue(out_ch))
        if emit == "words":
            return words, ref != 0
        return words.view(torch.uint8).reshape(bsz, n_max * out_ch), ref != 0
    filled = engine.place_fill(keys, [pays], totals, n_max, init)[0]
    out = _emit_pixels(filled, npx[:, 0], colch, out_ch, n_max)
    return _maybe_words(out, emit), ref != 0


def decode_stream(data, chunks_len: int, n_pixels: int, *, colch: int,
                  out_ch: int, n_max: int, emit: str = "u8",
                  src_alpha: bool = True):
    """Single-stream decode: (M,) uint8 -> (the row of
    decode_stream_batched's pixels for ``emit``, has_ref bool tensor). The
    JAX package has a second form of this with rank-1 internals for large
    images (``decode_stream_flat``), which answers a TPU layout; here
    ``parallel.tiled.decode_large`` calls this one."""
    dev = data.device
    out, has_ref = decode_stream_batched(
        data[None, :],
        torch.tensor([chunks_len], dtype=torch.int32, device=dev),
        torch.tensor([n_pixels], dtype=torch.int32, device=dev),
        colch=colch, out_ch=out_ch, n_max=n_max, emit=emit,
        src_alpha=src_alpha,
    )
    return out[0], has_ref[0]


def decode_stream_packed(data, seg_lens, *, colch: int, out_ch: int,
                         seg: int, seg_px: int, src_alpha: bool = True):
    """Segment-packed decode of small same-size images (the icon class).

    Each row of ``data`` (B, M) uint8 carries M/seg images: image j fills
    bytes [j*seg, (j+1)*seg) with its whole stream, header included,
    zero-padded, and must decode to EXACTLY seg_px pixels (a multiple of
    4). seg_lens: (B, M/seg) int32, each image's stream length less the end
    marker (0: an empty segment; its pixels repeat the image before).
    K1 in segment mode gives one op stream per row with global keys, K2
    places it over the row's n_out = (M/seg) * seg_px pixels. Returns
    (words, has_ref (B,) bool, per packed ROW: one REF or foreign image
    sends its row mates to the host decoder too). ``words`` is the
    emit="words" layout of decode_stream_batched over the row's pixels:
    int32 (B, n_out * out_ch // 4) for a color source at 3/4 channels,
    uint8/uint16 (B, n_out) for a mono source at 1/2, else the int32 view
    of the interleaved bytes; image j starts at byte j * seg_px * out_ch."""
    if colch not in (1, 3) or out_ch not in (1, 2, 3, 4):
        raise ValueError("colch must be 1 or 3 and out_ch 1 to 4")
    bsz, m = data.shape
    if seg_px <= 0 or seg_px % 4:
        raise ValueError("seg_px must be a positive multiple of 4")
    n_out = (m // seg) * seg_px
    mode = "mono" if colch == 1 else ("alpha" if src_alpha else "noalpha")
    keys, pays, totals, ref = frontend.decode_front_compact(
        data, seg_lens, n_out, mode=mode, seg=seg, seg_px=seg_px)
    npx = torch.full((bsz, 1), n_out, dtype=torch.int32, device=data.device)
    init = (_INIT_PACKED,)
    if colch == 1 and out_ch in (1, 2):
        epi = _dec_epilogue_mono(out_ch)
    elif colch == 3 and out_ch in (3, 4):
        epi = _dec_epilogue(out_ch)
    else:
        filled = engine.place_fill(keys, [pays], totals, n_out, init)[0]
        out = _emit_pixels(filled, npx[:, 0], colch, out_ch, n_out)
        return out.view(torch.int32), ref != 0
    return (engine.place_emit(keys, [pays], totals, npx, n_out, init, epi),
            ref != 0)
