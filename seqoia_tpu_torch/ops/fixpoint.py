"""K11: one pass of the .qoi decode's index fixpoint, fused.

No Pallas kernel: the JAX package computes a pass
(``seqoia_tpu/codec/decode_compat.py:80`` ``_op_values`` and its loop body)
as XLA ops around two segmented mod-256 sums of ``tile_scan``. The kernels
are ``csrc/fixpoint.cu``: ``k11_values`` (``op_values``), K8's look-back
scan with the pass's elementwise work in registers around it, writes each
op's packed RGBA and its QOI hash; ``k11_stable`` (``settled``) checks that
K7's answers equal the assumed INDEX values (see the source's header for
the design and what bounds it on the H100). The plain versions compute the
same elements and combine in int64, the scan by log-step doubling.

An element is one 32-bit word of four channel deltas (r in bits 0-7, as in
the packed pixel) and two reset flags (bit 0: the RGB channels, at RGB,
RGBA and INDEX ops; bit 1: alpha, at RGBA and INDEX ops); the combine adds
the words bytewise mod 256 and takes the right side's channels where it
resets them.
"""

from __future__ import annotations

import torch

from .. import spec
from ..utils import trace
from . import _build
from ._plain import U32, hillis_steele, to_i32
from .scan import scratch_words

F_RGB, F_A = 1, 2


def elements_plain(lo, hi, iv, totals):
    """Each op's element as int64 (word, flags): the deltas (or the absolute
    channels where the op resets them) of the op whose bytes 0-3 are ``lo``
    and byte 4 the low byte of ``hi``, given the assumed INDEX values ``iv``;
    (0, 0) at and past the row's op total."""
    lo = lo.long() & U32
    b0, b1 = lo & 255, (lo >> 8) & 255
    b4 = hi.long() & 255
    W = torch.where
    vg = (b0 & 0x3F) - 32

    def bytes3(r, g, b):
        return (r & 255) | ((g & 255) << 8) | ((b & 255) << 16)

    diff = bytes3(((b0 >> 4) & 3) - 2, ((b0 >> 2) & 3) - 2, (b0 & 3) - 2)
    luma = bytes3(vg - 8 + ((b1 >> 4) & 15), vg, vg - 8 + (b1 & 15))
    rgb = lo >> 8
    tag = b0 & spec.MASK_2
    is_index = b0 < spec.QOI_INDEX_SIZE
    word = W(is_index, iv.long() & U32,
             W(b0 == spec.OP_RGB, rgb,
               W(b0 == spec.OP_RGBA, rgb | (b4 << 24),
                 W(tag == spec.QOI_OP_DIFF, diff,
                   W(tag == spec.OP_LUMA, luma, 0)))))
    flags = W(is_index | (b0 == spec.OP_RGBA), F_RGB | F_A,
              W(b0 == spec.OP_RGB, F_RGB, 0))
    valid = torch.arange(lo.shape[-1], device=lo.device)[None, :] \
        < totals.to(lo.device).long()[:, None]
    return W(valid, word, 0), W(valid, flags, 0)


def combine_plain(left, right):
    """The kernel's combine on int64 (word, flags) pairs, left then right."""
    (lv, lf), (rv, rf) = left, right
    keep = (torch.where(rf & F_RGB != 0, 0x00FFFFFF, 0)
            | torch.where(rf & F_A != 0, 0xFF000000, 0))
    s = ((lv & 0x7F7F7F7F) + (rv & 0x7F7F7F7F)) ^ ((lv ^ rv) & 0x80808080)
    return (rv & keep) | (s & ~keep & U32), lf | rf


def pixels_plain(word, flags, totals):
    """Packed RGBA and QOI hash (-1 at and past the row's op total) from
    the inclusive folds: alpha is 255 until the first RGBA or INDEX op
    (seqoia.h:716-719). Returns two int32 tensors."""
    a = word >> 24
    alpha = torch.where(flags & F_A != 0, a, (a + 255) & 255)
    px = (word & 0x00FFFFFF) | (alpha << 24)
    h = spec.color_hash(px & 255, (px >> 8) & 255, (px >> 16) & 255, alpha)
    valid = torch.arange(px.shape[-1], device=px.device)[None, :] \
        < totals.to(px.device).long()[:, None]
    return to_i32(px), torch.where(valid, h, -1).to(torch.int32)


def op_values_plain(lo, hi, iv, totals, hashes: bool = True):
    """Plain PyTorch K11 values (see ``op_values``)."""
    word, flags = hillis_steele(elements_plain(lo, hi, iv, totals),
                                combine_plain)
    px, h = pixels_plain(word, flags, totals)
    return px, (h if hashes else None)


def settled_plain(got, iv):
    """Plain PyTorch K11 check (see ``settled``)."""
    return (got == iv).all(dim=-1)


def _strided(x, like):
    """x and its row stride: a (B, M) int32 tensor of ``like``'s shape and
    device whose rows may be views into wider rows, made contiguous where
    its rows are not."""
    shape = tuple(like.shape)
    if x.dtype != torch.int32 or tuple(x.shape) != shape \
            or x.device != like.device:
        raise ValueError("lo, hi and iv must be (B, M) int32 tensors of one "
                         "shape and device")
    if shape[1] > 1 and x.stride(1) != 1 or x.stride(0) < shape[1]:
        x = x.contiguous()
    return x, x.stride(0)


def op_values(lo, hi, iv, totals, hashes: bool = True):
    """K11 values. lo: each op's bytes 0-3, hi: its byte 4 in the low byte
    (``decode_compat._ops``), iv: the assumed INDEX values, all (B, M)
    int32 (rows may be views into wider rows); totals: (B,) ops a row.
    Returns (px, hashes): the packed RGBA after each op, and its QOI color
    hash, -1 at and past the row's total (None unless ``hashes``), both
    (B, M) int32.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if lo.dim() != 2:
        raise ValueError("lo, hi and iv must be (B, M) int32 tensors of one "
                         "shape")
    bsz, m = lo.shape
    hi, ld_hi = _strided(hi, lo)
    iv, ld_iv = _strided(iv, lo)
    lo, ld_lo = _strided(lo, lo)
    if totals.shape != (bsz,):
        raise ValueError("totals must be (B,)")
    dev = lo.device
    if not lo.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return op_values_plain(lo, hi, iv, totals, hashes)
    i32 = dict(dtype=torch.int32, device=dev)
    px = torch.empty((bsz, m), **i32)
    h = torch.empty((bsz, m), **i32) if hashes else None
    scratch = torch.empty(scratch_words(bsz, m), **i32)
    P = _build.ptr
    trace.count("kernels.launches.K11")
    _build.launch("fixpoint", "k11_values", dev, P(lo), ld_lo, P(hi), ld_hi,
                  P(iv), ld_iv, P(totals.to(**i32).contiguous()), bsz, m,
                  P(scratch), P(px), P(h))
    return px, h


def settled(got, iv):
    """K11 check: (B,) bool, True where row b of ``got`` (K7's answers)
    equals row b of ``iv`` (the values the pass assumed) everywhere. got,
    iv: (B, M) int32.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if got.dim() != 2 or got.dtype != torch.int32 or iv.dtype != torch.int32 \
            or got.shape != iv.shape or got.device != iv.device:
        raise ValueError("got and iv must be (B, M) int32 tensors of one "
                         "shape and device")
    if not got.is_cuda:
        if got.device.type != "cpu":
            raise ValueError(f"unsupported device {got.device}")
        return settled_plain(got, iv)
    bsz, m = got.shape
    stable = torch.empty(bsz, dtype=torch.bool, device=got.device)
    P = _build.ptr
    trace.count("kernels.launches.K11")
    _build.launch("fixpoint", "k11_stable", got.device,
                  P(got.contiguous()), P(iv.contiguous()), bsz, m, P(stable))
    return stable
