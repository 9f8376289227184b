"""K3: SQOA encode front-end, packed pixels -> compacted emission stream.

Port of ``seqoia_tpu/ops/pallas_encode.py:encode_front_compact``. The kernel
is ``csrc/encode_front.cu``: one launch whose 4096-pixel tiles are chained
by two decoupled look-backs (the last change, then the entry and byte
counts); see its header for the design and what bounds it on the H100.
``encode_front_plain`` is the same function in plain PyTorch, in the form
of the JAX package's XLA path (``encode_v2.encode_stream_batched``,
non-compat branch).

Per pixel: the change/run segmentation against the previous pixel
(``init_prev`` before the first), the pending run flushed by a change and
the BIGRUN every 512 repeated pixels (reference: seqoia.h:544-561), the
op class and its wrapped deltas packed into the meta word
(``encode_v2._pack_meta``'s layout) and the bytes it emits. The emitting
pixels are compacted in order into (byte offset, pixel, meta).
``lc0 = -(run_in + 1)`` carries a run into the row (-1: none).
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from ._plain import compact_rows, hillis_steele

INIT_PACKED = -16777216  # (0, 0, 0, 255): the codec's initial pixel

CL_LUMA, CL_RGB, CL_MONO_GA, CL_NONE = 0, 1, 2, 7


TILE = 4096  # pixels a tile (a block) of the kernel


def scratch_words(bsz: int, n: int) -> int:
    """int32 words of a K3 launch's scratch over (bsz, n) pixels: a 64-bit
    tile counter and two 64-bit status words per tile (the last change,
    the entry and byte counts)."""
    return 2 * (2 * bsz * -(-n // TILE) + 1)


def _wrap8(x):
    return ((x + 128) & 255) - 128


def pack_meta(pending, cls, vg, vg_r, vg_b, va):
    """Meta word: bits 0-8 pending, 9-11 class, 12-17 vg+32, 18-21 vg_r+8,
    22-25 vg_b+8, 26-30 va+16, 31 alpha changed (encode_v2._pack_meta);
    in pending's dtype (int64 holds the 32 bits, int32 their pattern)."""
    return (
        pending | (cls << 9)
        | (((vg + 32) & 63) << 12) | (((vg_r + 8) & 15) << 18)
        | (((vg_b + 8) & 15) << 22) | (((va + 16) & 31) << 26)
        | ((va != 0).to(pending.dtype) << 31)
    )


def _max_combine(left, right):
    return (torch.maximum(left[0], right[0]),)


def encode_front_plain(packed, n_valid, colch: int, init_prev, lc0):
    """Plain PyTorch K3 (see module docstring). Entries past the entry
    totals are 0."""
    px = packed.long()
    bsz, n = px.shape
    idx = torch.arange(n, device=px.device)[None, :]
    valid = idx < n_valid.long()[:, None]
    prev = torch.cat([init_prev.long()[:, None], px[:, :-1]], dim=1)
    same = (px == prev) & valid
    change = (~same) & valid

    (lc,) = hillis_steele((torch.where(change, idx, -(2**40)),), _max_combine)
    last_change = torch.maximum(lc, lc0.long()[:, None])
    prev_change = torch.cat([lc0.long()[:, None], last_change[:, :-1]], dim=1)
    pending = torch.where(change, (idx - 1 - prev_change) & 511, 0)
    flush_n = torch.where(pending > 0, (pending - 1) // 61 + 1, 0)
    bigrun = same & (((idx - last_change) & 511) == 0)

    cr, cg = px & 255, (px >> 8) & 255
    cb, ca = (px >> 16) & 255, (px >> 24) & 255
    pr, pg = prev & 255, (prev >> 8) & 255
    pb, pa = (prev >> 16) & 255, (prev >> 24) & 255
    vg = _wrap8(cg - pg)
    va = _wrap8(ca - pa)
    if colch == 3:
        vg_r = _wrap8(_wrap8(cr - pr) - vg)
        vg_b = _wrap8(_wrap8(cb - pb) - vg)
        luma_ok = ((vg_r >= -8) & (vg_r <= 7) & (vg >= -32) & (vg <= 31)
                   & (vg_b >= -8) & (vg_b <= 7) & (va >= -16) & (va <= 15))
        cls = torch.where(luma_ok, CL_LUMA, CL_RGB)
        op_len = torch.where(luma_ok, 2, 4) + (va != 0).long()
    else:
        # mono keeps r = b = 0: the reference's shared LUMA guard sees
        # vg_r = vg_b = -vg, so the mono window is vg in [-7, 8]
        vg_r = vg_b = torch.zeros_like(vg)
        luma_ok = (vg >= -7) & (vg <= 8) & (va >= -16) & (va <= 15)
        cls = torch.where(va != 0, CL_MONO_GA,
                          torch.where(luma_ok, CL_LUMA, CL_RGB))
        op_len = torch.where(va != 0, 3, torch.where(luma_ok, 1, 2))

    total_len = torch.where(change, flush_n + op_len, bigrun.long())
    cls = torch.where(change, cls, CL_NONE)
    meta = pack_meta(pending, cls, vg, vg_r, vg_b, va)
    offsets = torch.cumsum(total_len, dim=1) - total_len

    emit = total_len > 0
    keys_c, cur_c, meta_c = compact_rows(emit, offsets, px, meta)
    # a row without a change keeps the run carried in: lc0, not -1
    last_c = torch.where(change, idx, -(2**40)).amax(dim=1)
    return (
        keys_c, [cur_c, meta_c],
        emit.sum(dim=1).to(torch.int32),
        total_len.sum(dim=1).to(torch.int32),
        torch.maximum(last_c, lc0.long()).to(torch.int32),
    )


def encode_front_compact(packed, n_valid, colch: int = 3, init_prev=None,
                         lc0=None):
    """K3. packed: (B, N) int32 normalized pixels; n_valid (B,) (read as
    clamped to [0, N], as the plain version's mask reads it);
    init_prev: the pixel before each row (default: the initial pixel);
    lc0: -(run_in + 1) per row (default -1). Returns (keys = byte offsets,
    [cur, meta] (B, N) int32 valid below entry_totals, entry_totals (B,),
    chunk_totals (B,), last_change (B,)).

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError("packed must be a (B, N) int32 tensor")
    if colch not in (1, 3):
        raise ValueError("colch must be 1 or 3")
    bsz, n = packed.shape
    dev = packed.device
    if init_prev is None:
        init_prev = torch.full((bsz,), INIT_PACKED, dtype=torch.int32,
                               device=dev)
    if lc0 is None:
        lc0 = torch.full((bsz,), -1, dtype=torch.int32, device=dev)
    for v in (n_valid, init_prev, lc0):
        if v.shape != (bsz,):
            raise ValueError("n_valid, init_prev and lc0 must be (B,)")
    if not packed.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return encode_front_plain(packed, n_valid, colch, init_prev, lc0)
    if n >= 2**30:
        raise ValueError("rows must be below 2**30 pixels (30-bit entry "
                         "counts)")
    i32 = dict(dtype=torch.int32, device=dev)
    packed = packed.contiguous()
    nv, ip, l0 = (v.to(**i32).contiguous() for v in (n_valid, init_prev, lc0))
    scratch = torch.empty(scratch_words(bsz, n), **i32)
    keys, curs, metas = (torch.empty((bsz, n), **i32) for _ in range(3))
    et, ct, lc = (torch.empty(bsz, **i32) for _ in range(3))
    P = _build.ptr
    trace.count("kernels.launches.K3")
    _build.launch(
        "encode_front", "k3_encode_front", dev,
        P(packed), P(nv), P(ip), P(l0), bsz, n, colch, P(scratch), P(keys),
        P(curs), P(metas), P(et), P(ct), P(lc))
    return keys, [curs, metas], et, ct, lc
