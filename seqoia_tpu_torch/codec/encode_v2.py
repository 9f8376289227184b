"""SQOA (non-compat) stream encode on the card.

Port of the fused branch of ``seqoia_tpu/codec/encode_v2.py``
(``encode_stream_batched``, ``encode_stream``): K3 turns the packed pixels
into the compacted emission stream (byte offset, pixel, meta word per
emitting pixel), K2 spreads it over the output bytes and its encode
epilogue computes every byte in closed form — the run flush chunks, the
op bytes, the trailing BIGRUN and the end marker (reference:
seqoia.h:544-646). The meta word's layout (the JAX package's
``encode_v2._pack_meta``) is K3's: ``ops/encode_front.pack_meta``.
"""

from __future__ import annotations

import torch

from .. import spec
from ..ops import encode_front, engine

_INIT_PACKED = encode_front.INIT_PACKED
_CL_LUMA, _CL_MONO_GA, _CL_NONE = (
    encode_front.CL_LUMA, encode_front.CL_MONO_GA, encode_front.CL_NONE)


def _emit_inits():
    """K2 fill inits: (pixel, meta, byte offset) before the first entry."""
    return (_INIT_PACKED, _CL_NONE << 9, 0)


def _flush_byte(pending, k):
    """k-th byte of the run flush for ``pending`` pixels (seqoia.h:554-561);
    (pending - 1) // 61 as a multiply-shift, exact for 0..511."""
    n_full = ((pending - 1).clamp(min=0) * 538) >> 15
    rem = pending - 61 * n_full
    return torch.where(k >= n_full, spec.OP_RUN | (rem - 1),
                       spec.OP_RUN | 60)


def _emit_bytes(colch: int, filled, t, scal):
    """Plain PyTorch encode epilogue: the stream byte at each position t
    from the filled (pixel, meta, offset) of its emitting pixel."""
    cur_f, meta_f, off_f = filled
    chunk_total, trail, emit_tail = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    k = t - off_f
    pend = meta_f & 0x1FF
    cls = (meta_f >> 9) & 7
    flush = torch.where(pend > 0, (((pend - 1).clamp(min=0) * 538) >> 15) + 1,
                        0)
    ocr, ocg = cur_f & 255, (cur_f >> 8) & 255
    ocb, oca = (cur_f >> 16) & 255, (cur_f >> 24) & 255
    ovg = ((meta_f >> 12) & 63) - 32
    ovg_r = ((meta_f >> 18) & 15) - 8
    ovg_b = ((meta_f >> 22) & 15) - 8
    ova = ((meta_f >> 26) & 31) - 16
    oalpha = (meta_f >> 31) & 1
    j = k - flush
    W = torch.where
    if colch == 3:
        op = W(cls == _CL_LUMA,
               W(j == 0, spec.OP_LUMA | (ovg + 32),
                 W(j == 1, ((ovg_r + 8) << 4) | (ovg_b + 8),
                   spec.OP_ALPHA | (ova + 16))),
               W(j == 0, spec.OP_RGB | oalpha,
                 W(j == 1, ocr, W(j == 2, ocg, W(j == 3, ocb, oca)))))
    else:
        op = W(cls == _CL_MONO_GA,
               W(j == 0, spec.OP_RGBA, W(j == 1, ocg, oca)),
               W(cls == _CL_LUMA, spec.OP_LUMA | (ovg + 32),
                 W(j == 0, spec.OP_RGB | oalpha, W(j == 1, ocg, oca))))
    byte = W(k < flush, _flush_byte(pend, k), op)
    byte = W(cls == _CL_NONE, spec.OP_BIGRUN, byte)

    total = chunk_total + W(emit_tail != 0, 8 + trail, 0)
    tail_pos = t - chunk_total
    in_tail = (tail_pos >= 0) & (t < total) & (emit_tail != 0)
    tail_byte = W(tail_pos == W(trail != 0, 0, -1), spec.OP_BIGRUN,
                  W(tail_pos == W(trail != 0, 8, 7), 1, 0))
    out = W(in_tail, tail_byte, byte)
    return (W(t < total, out, 0) & 255).to(torch.uint8)


def _emit_epilogue(colch: int) -> engine.Epilogue:
    """Encode emission in K2 (uint8 stream bytes), scalars (chunk_total,
    has_trail, emit_tail) per row."""
    kind = engine.EPI_ENC3 if colch == 3 else engine.EPI_ENC1
    return engine.Epilogue(
        kind, torch.uint8, lambda f, t, s: _emit_bytes(colch, f, t, s))


def emit_scalars(n_valid, chunk_totals, last_c):
    """K2's encode scalars (chunk_total, has_trail, emit_tail) per row and
    the exact stream totals, from K3's chunk totals and last changes."""
    nv = n_valid.to(device=chunk_totals.device, dtype=torch.int32)
    trail_pending = ((nv - 1) - last_c) % spec.SQOA_MAXRUN
    has_trail = ((trail_pending > 0) & (nv > 0)).to(torch.int32)
    total = chunk_totals + 8 + has_trail
    scal = torch.stack(
        [chunk_totals, has_trail, torch.ones_like(chunk_totals)], dim=-1)
    return scal, total


def encode_stream_batched(packed, n_valid, *, colch: int, out_cap: int):
    """Encode a batch of packed (B, N) int32 pixel rows (r|g<<8|b<<16|a<<24,
    normalized per encode.normalize_pixels_packed), n_valid (B,) pixels
    each. Returns ((B, out_cap) uint8 chunk bytes + trailing BIGRUN + end
    marker, (B,) int32 exact totals — a total above out_cap means the
    output was cut and the caller must retry with a larger cap)."""
    keys, pays, n_entries, chunk_totals, last_c = (
        encode_front.encode_front_compact(packed, n_valid, colch=colch))
    scal, total = emit_scalars(n_valid, chunk_totals, last_c)
    out = engine.place_emit(keys, pays, n_entries, scal, out_cap,
                            _emit_inits(), _emit_epilogue(colch))
    return out, total


def encode_stream(packed, n_valid: int, *, colch: int, out_cap: int):
    """Single-image encode: packed (N,) int32 -> ((out_cap,) uint8, total)."""
    out, total = encode_stream_batched(
        packed[None],
        torch.tensor([n_valid], dtype=torch.int32, device=packed.device),
        colch=colch, out_cap=out_cap,
    )
    return out[0], total[0]
