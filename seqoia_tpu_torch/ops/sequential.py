"""K9: sequential decode of QOI-compat color ops, one thread per stream.

Port of the sequential scan decoder's step
(``seqoia_tpu/codec/decode_jax.py:_compat_scan_step``, run by
``decode_stream_compat``'s ``lax.scan``), for color streams. It is no
Pallas kernel: the port runs it on the ``.qoi`` rows the index fixpoint
leaves unsettled after its bounded passes (``codec/decode_compat.py``),
where the JAX package decodes them on the host. The kernel is
``csrc/sequential.cu`` (see its header for what bounds it on the H100);
``sequential_decode_plain`` is the same walk in plain PyTorch, one step per
op over all rows at once.
"""

from __future__ import annotations

import torch

from . import _build
from ._plain import to_i32

_INIT = 0xFF000000  # (0, 0, 0, 255): the decoder's initial pixel


def sequential_decode_plain(lo, hi, totals):
    """Plain PyTorch K9 (see ``sequential_decode``)."""
    bsz, mo = lo.shape
    dev = lo.device
    w_all = lo.long() & 0xFFFFFFFF
    a_all = hi.long() & 255
    rows = torch.arange(bsz, device=dev)
    px = torch.full((bsz,), _INIT, dtype=torch.long, device=dev)
    tab = torch.zeros((bsz, 64), dtype=torch.long, device=dev)
    out = torch.zeros((bsz, mo), dtype=torch.long, device=dev)
    tot = totals.to(device=dev, dtype=torch.long)
    W = torch.where
    for j in range(min(int(tot.max()), mo) if bsz else 0):
        w = w_all[:, j]
        b0 = w & 255
        r, g, b = px & 255, (px >> 8) & 255, (px >> 16) & 255
        alpha = px & 0xFF000000
        b1 = (w >> 8) & 255
        vg = (b0 & 0x3F) - 32
        is_diff = b0 < 0x80
        dr = W(is_diff, ((b0 >> 4) & 3) - 2, vg - 8 + ((b1 >> 4) & 15))
        dg = W(is_diff, ((b0 >> 2) & 3) - 2, vg)
        db = W(is_diff, (b0 & 3) - 2, vg - 8 + (b1 & 15))
        delta = alpha | ((r + dr) & 255) | (((g + dg) & 255) << 8) \
            | (((b + db) & 255) << 16)
        new = W(b0 < 0xC0, delta, px)  # RUN: the value carries
        new = W(b0 == 0xFE, alpha | (w >> 8), new)
        new = W(b0 == 0xFF, (w >> 8) | (a_all[:, j] << 24), new)
        new = W(b0 < 64, tab[rows, b0.clamp(max=63)], new)
        live = j < tot
        px = W(live, new, px)
        slot = ((px & 255) * 3 + ((px >> 8) & 255) * 5
                + ((px >> 16) & 255) * 7 + (px >> 24) * 11) & 63
        tab[rows, slot] = W(live, px, tab[rows, slot])
        out[:, j] = W(live, px, 0)
    return to_i32(out)


def sequential_decode(lo, hi, totals):
    """K9. lo: (B, mo) int32, bytes 0-3 of each op (byte 0 the tag); hi:
    (B, mo) int32, byte 4 (the alpha of an RGBA op); totals: (B,) ops per
    row. Returns (B, mo) int32: the packed RGBA pixel after each op (the
    decoder's running value, INDEX reads resolved sequentially), 0 past a
    row's total.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if lo.dim() != 2 or lo.dtype != torch.int32:
        raise ValueError("lo must be a (B, mo) int32 tensor")
    if hi.shape != lo.shape or hi.dtype != torch.int32:
        raise ValueError("hi must match lo: (B, mo) int32")
    bsz, mo = lo.shape
    if totals.shape != (bsz,):
        raise ValueError("totals must be (B,)")
    dev = lo.device
    if not lo.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return sequential_decode_plain(lo, hi, totals)
    out = torch.zeros((bsz, mo), dtype=torch.int32, device=dev)
    lib = _build.load("sequential")
    P = _build.ptr
    sequential_decode.launches += 1
    rc = lib.k9_sequential_decode(
        P(lo.contiguous()), P(hi.contiguous()),
        P(totals.to(dtype=torch.int32, device=dev).contiguous()), bsz, mo,
        P(out), _build.stream_ptr(dev))
    _build.check(rc, "k9_sequential_decode")
    return out


sequential_decode.launches = 0
