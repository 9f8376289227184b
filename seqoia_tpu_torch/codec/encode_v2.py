"""SQOA and QOI-compat stream encode on the card.

Port of ``seqoia_tpu/codec/encode_v2.py`` (``encode_stream_batched``,
``encode_stream``). SQOA (non-compat) runs the fused branch: K3 turns the
packed pixels into the compacted emission stream (byte offset, pixel, meta
word per emitting pixel), K2 spreads it over the output bytes and its
encode epilogue computes every byte in closed form — the run flush chunks,
the op bytes, the trailing BIGRUN and the end marker (reference:
seqoia.h:544-646). The meta word's layout (the JAX package's
``encode_v2._pack_meta``) is K3's: ``ops/encode_front.pack_meta``.

QOI-compat (``.qoi``, color only) runs the compat branch: the change and
run segmentation (K8's running max of change positions), the index-table
hit of each change pixel (``_compat_found``, K7), the op classes and byte
counts as torch ops, K5 compaction of the emitting pixels, then K2 with the
compat epilogue (``EPI_ENCQ``): it spreads (pixel, meta, offset) over the
output bytes and computes each byte in closed form, as the SQOA branch does.
The JAX package spreads with K6 and emits the bytes in XLA instead; the
bytes are the same. ``_compat_bytes`` is the epilogue's plain version.

Both branches know each row's exact stream total before K2 runs (the
front's byte totals and last changes give it, ``emit_scalars``), so
without an explicit ``out_cap`` K2's output is sized from the batch's
largest total (``exact_cap``, one device-to-host read): one front and one
K2 per call, never a retry at a larger cap.
"""

from __future__ import annotations

import torch

from .. import spec
from ..ops import compact, encode_front, engine, scan, scan_ops, slots
from ..utils import trace

_INIT_PACKED = encode_front.INIT_PACKED
_wrap8 = encode_front._wrap8
_CL_LUMA, _CL_MONO_GA, _CL_NONE = (
    encode_front.CL_LUMA, encode_front.CL_MONO_GA, encode_front.CL_NONE)
# the compat classes (3 bits of the meta word, beside K3's)
_CL_INDEX, _CL_RGBA5, _CL_DIFF, _CL_RGB4 = 3, 4, 5, 6


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


def emit_scalars(n_valid, chunk_totals, last_c, maxrun=spec.SQOA_MAXRUN,
                 emit_tail=None):
    """The encode scalars (chunk_total, has_trail, emit_tail) per row and
    the exact stream totals, from the chunk totals and last changes
    (maxrun: 512 for SQOA, 62 for QOI-compat). ``emit_tail`` (B,): 0 for a
    row that does not end its image, which then gets neither the trailing
    run nor the end marker (default: every row ends one)."""
    i32 = dict(device=chunk_totals.device, dtype=torch.int32)
    nv = n_valid.to(**i32)
    tail = (torch.ones_like(chunk_totals) if emit_tail is None
            else (emit_tail.to(**i32) != 0).to(torch.int32))
    trail_pending = ((nv - 1) - last_c) % maxrun
    has_trail = ((trail_pending > 0) & (nv > 0)).to(torch.int32) * tail
    total = chunk_totals + (8 + has_trail) * tail
    scal = torch.stack([chunk_totals, has_trail, tail], dim=-1)
    return scal, total


def exact_cap(total) -> int:
    """K2's output length for exact stream totals ``total`` (B,): the
    largest, rounded up to K2's multiple of 4 (one device-to-host read)."""
    trace.host_sync("exact_cap")
    with trace.span("parallel.wait", why="exact_total"):
        return max(-(-int(total.max()) // 4) * 4, 4)


def _channels(px):
    return px & 255, (px >> 8) & 255, (px >> 16) & 255, (px >> 24) & 255


def _compat_found(packed, change, hashes, n_valid):
    """Index-table hit per change pixel: the slot holds the color of the
    latest earlier change pixel with the same hash, and the table starts
    zeroed, so a first-seen (0, 0, 0, 0) hits too (insert on every miss,
    seqoia.h:518,563-582). One K7 pass, the change pixels both writing and
    querying their own hash."""
    wr = torch.where(change, hashes, -1).to(torch.int32)
    got = slots.slot_last_writer(wr, packed, wr, init=0, n_live=n_valid)
    return change & (got == packed)


def _compat_bytes(filled, t, scal):
    """The QOI-compat stream byte at each position t (int32 torch ops)
    from the filled (pixel, meta, offset) of its emitting pixel: the run
    flush (one byte: a compat run is cut at 62), the op bytes, the
    trailing run and the end marker (reference: seqoia.h:544-646)."""
    cur_f, meta_f, off_f = filled
    chunk_total, trail = scal[:, 0:1], scal[:, 1:2]
    W = torch.where
    k = t - off_f
    pend = meta_f & 0x1FF
    cls = (meta_f >> 9) & 7
    ocr, ocg, ocb, oca = _channels(cur_f)
    ovg = ((meta_f >> 12) & 63) - 32
    ovg_r = ((meta_f >> 18) & 15) - 8
    ovg_b = ((meta_f >> 22) & 15) - 8
    flush = (pend > 0).to(torch.int32)
    j = k - flush
    diff = (spec.QOI_OP_DIFF | ((_wrap8(ovg + ovg_r) + 2) << 4)
            | ((ovg + 2) << 2) | (_wrap8(ovg + ovg_b) + 2))
    luma = W(j == 0, spec.OP_LUMA | (ovg + 32), ((ovg_r + 8) << 4) | (ovg_b + 8))
    tag = spec.OP_RGB | (cls == _CL_RGBA5).to(torch.int32)  # 0xFE / 0xFF
    absolute = W(j == 0, tag, W(j == 1, ocr, W(j == 2, ocg,
                                             W(j == 3, ocb, oca))))
    op = W(cls == _CL_INDEX, spec.color_hash(ocr, ocg, ocb, oca),
           W(cls == _CL_DIFF, diff, W(cls == _CL_LUMA, luma, absolute)))
    byte = W(k < flush, spec.OP_RUN | (pend - 1), op)
    byte = W(cls == _CL_NONE, spec.OP_BIGRUN, byte)
    total = chunk_total + 8 + trail
    tail_pos = t - chunk_total
    tail = W(tail_pos == W(trail != 0, 0, -1), spec.OP_BIGRUN,
             (tail_pos == W(trail != 0, 8, 7)).to(torch.int32))
    out = W((tail_pos >= 0) & (t < total), tail, byte)
    return (W(t < total, out, 0) & 255).to(torch.uint8)


def _compat_epilogue() -> engine.Epilogue:
    """QOI-compat emission in K2 (uint8 stream bytes), scalars
    (chunk_total, has_trail, emit_tail) per row."""
    return engine.Epilogue(engine.EPI_ENCQ, torch.uint8, _compat_bytes)


def _encode_compat(packed, n_valid, out_cap: int | None):
    """The compat branch of encode_stream_batched (see the module
    docstring)."""
    bsz, n = packed.shape
    dev = packed.device
    i32 = dict(dtype=torch.int32, device=dev)
    nv = n_valid.to(**i32)
    idx = torch.arange(n, **i32)[None, :]
    valid = idx < nv[:, None]
    prev = torch.cat([torch.full((bsz, 1), _INIT_PACKED, **i32),
                      packed[:, :-1]], dim=1)
    same = (packed == prev) & valid
    change = ~same & valid

    last_change = scan.cummax(torch.where(change, idx, -1))
    prev_change = torch.cat([torch.full((bsz, 1), -1, **i32),
                             last_change[:, :-1]], dim=1)
    pending = torch.where(change, (idx - 1 - prev_change) % spec.QOI_MAXRUN,
                          0)
    bigrun = same & ((idx - last_change) % spec.QOI_MAXRUN == 0)
    del prev_change

    cr, cg, cb, ca = _channels(packed)
    pr, pg, pb, pa = _channels(prev)
    vr, vg = _wrap8(cr - pr), _wrap8(cg - pg)
    vb, va = _wrap8(cb - pb), _wrap8(ca - pa)
    vg_r, vg_b = _wrap8(vr - vg), _wrap8(vb - vg)
    luma_ok = ((vg_r >= -8) & (vg_r <= 7) & (vg >= -32) & (vg <= 31)
               & (vg_b >= -8) & (vg_b <= 7) & (va >= -16) & (va <= 15))
    diff_ok = ((vr >= -2) & (vr <= 1) & (vg >= -2) & (vg <= 1)
               & (vb >= -2) & (vb <= 1))
    found = _compat_found(packed, change, spec.color_hash(cr, cg, cb, ca), nv)
    W = torch.where
    cls = W(found, _CL_INDEX, W(va != 0, _CL_RGBA5, W(
        diff_ok, _CL_DIFF, W(luma_ok, _CL_LUMA, _CL_RGB4)))).to(torch.int32)
    op_len = W(found, 1, W(va != 0, 5, W(diff_ok, 1, W(luma_ok, 2, 4)))
               ).to(torch.int32)
    # a pending run (at most 61 pixels) flushes as one RUN byte
    total_len = W(change, (pending > 0).to(torch.int32) + op_len,
                  bigrun.to(torch.int32))
    cls = W(change, cls, _CL_NONE)
    offsets = scan_ops.blocked_cumsum(total_len)
    chunk_total = offsets[:, -1].contiguous()
    offsets = offsets - total_len
    meta = encode_front.pack_meta(pending, cls, vg, vg_r, vg_b, va)
    last_c = W(change, idx, -1).amax(dim=-1)
    scal, total = emit_scalars(nv, chunk_total, last_c, spec.QOI_MAXRUN)

    keys_c, pays_c, n_entries = compact.compact(total_len > 0, offsets,
                                                [packed, meta])
    cap = exact_cap(total) if out_cap is None else out_cap
    return engine.place_emit(keys_c, pays_c, n_entries, scal, cap,
                             _emit_inits(), _compat_epilogue()), total


def encode_stream_batched(packed, n_valid, *, colch: int,
                          out_cap: int | None = None, compat: bool = False,
                          init_prev=None, run_in=None, emit_tail=None):
    """Encode a batch of packed (B, N) int32 pixel rows (r|g<<8|b<<16|a<<24,
    normalized per encode.normalize_pixels_packed), n_valid (B,) pixels
    each, as SQOA or (``compat``, colch 3 only) QOI-compat streams.
    Returns ((B, cap) uint8 chunk bytes + trailing run + end marker, (B,)
    int32 exact totals). cap is ``out_cap`` if given (a total above it
    means that row's output was cut), else ``exact_cap(totals)``: every
    row whole.

    The three carries, (B,) each and SQOA only, make a row a SHARD of a
    larger image (``parallel/tiled.py``): ``init_prev`` the packed pixel
    before the row (default: the codec's initial (0, 0, 0, 255),
    seqoia.h:520-525), ``run_in`` the length mod 512 of the run in progress
    at its start (it carries the BIGRUN phase and the pending flush across
    the boundary, seqoia.h:544-561), ``emit_tail`` whether the row ends the
    image (trailing BIGRUN and end marker, seqoia.h:640-646)."""
    if compat:
        if colch != 3:
            raise ValueError("QOI-compat encodes color sources only")
        if not (init_prev is None and run_in is None and emit_tail is None):
            raise ValueError("QOI-compat streams take no shard carries")
        return _encode_compat(packed, n_valid, out_cap)
    # the run carried in enters K3 as a change anchor at -(run_in + 1)
    lc0 = None if run_in is None else -(run_in.to(torch.int32) + 1)
    keys, pays, n_entries, chunk_totals, last_c = (
        encode_front.encode_front_compact(packed, n_valid, colch=colch,
                                          init_prev=init_prev, lc0=lc0))
    scal, total = emit_scalars(n_valid, chunk_totals, last_c,
                               emit_tail=emit_tail)
    cap = exact_cap(total) if out_cap is None else out_cap
    out = engine.place_emit(keys, pays, n_entries, scal, cap,
                            _emit_inits(), _emit_epilogue(colch))
    return out, total


def encode_stream(packed, n_valid: int, *, colch: int,
                  out_cap: int | None = None, compat: bool = False):
    """Single-image encode: packed (N,) int32 -> ((cap,) uint8, total)."""
    out, total = encode_stream_batched(
        packed[None],
        torch.tensor([n_valid], dtype=torch.int32, device=packed.device),
        colch=colch, out_cap=out_cap, compat=compat,
    )
    return out[0], total[0]


def encode_stream_flat(packed, n_valid: int, *, colch: int,
                       out_cap: int | None = None,
                       init_prev: int | None = None, run_in: int = 0,
                       emit_tail: int = 1):
    """Single large-image SQOA encode: packed (N,) int32 -> ((cap,) uint8,
    total), with the shard carries of encode_stream_batched as
    scalars. The JAX package keeps rank-1 internals here because a (1, N)
    buffer pads 8x in the TPU's layout; a card has no such padding, so this
    is the batched function at one row."""
    def one(v):
        return torch.tensor([v], dtype=torch.int32, device=packed.device)

    out, total = encode_stream_batched(
        packed[None], one(n_valid), colch=colch, out_cap=out_cap,
        init_prev=None if init_prev is None else one(init_prev),
        run_in=one(run_in), emit_tail=one(emit_tail))
    return out[0], total[0]
