"""K9: sequential decode of QOI-compat ops, one row a warp.

Port of the sequential scan decoder's step
(``seqoia_tpu/codec/decode_jax.py:_compat_scan_step``, run by
``decode_stream_compat``'s ``lax.scan``), in its color and mono forms. It is
no Pallas kernel: the port runs it on the color ``.qoi`` rows the index
fixpoint leaves unsettled after its bounded passes (``codec/
decode_compat.py``), where the JAX package decodes them on the host, and on
every mono ``.qoi`` row, as the JAX package does. The kernel is
``csrc/sequential.cu`` (see its header for the two steps, what bounds it
on the H100 and its design: ops pre-decoded 32 at a time into a keep mask,
a byte-wise addend and an INDEX slot, walked by one lane a row);
``sequential_decode_plain`` is the same walk in plain PyTorch, one step per
op over all rows at once.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from ._plain import to_i32

_INIT = 0xFF000000  # (0, 0, 0, 255): the decoder's initial pixel
#: the kernel's walk geometry (``csrc/sequential.cu``'s LANES and STAGES):
#: ops a chunk, and the chunks its ring of op words holds
CHUNK, RING = 32, 4


def _color_step(px, w, a, tab, rows):
    """The color step: (the value after op word w, its 64-slot hash)."""
    W = torch.where
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
    new = W(b0 == 0xFF, (w >> 8) | (a << 24), new)
    new = W(b0 < 64, tab[rows, b0.clamp(max=63)], new)
    slot = ((new & 255) * 3 + ((new >> 8) & 255) * 5
            + ((new >> 16) & 255) * 7 + (new >> 24) * 11) & 63
    return new, slot


def _mono_step(px, w, tab, rows):
    """The mono step (gray in byte 0, alpha in byte 3): (the value after op
    word w, its 128-slot hash, the reference's (g*5 + a*11) % 128)."""
    W = torch.where
    b0 = w & 255
    alpha = px & 0xFF000000
    gray = (w >> 8) & 255
    new = W((b0 >= 0x80) & (b0 < 0xC0),  # LUMA
            alpha | ((px + (b0 & 63) - 32) & 255), px)  # RUN: carries
    new = W(b0 == 0xFE, alpha | gray, new)
    new = W(b0 == 0xFF, gray | (((w >> 16) & 255) << 24), new)
    new = W(b0 < 128, tab[rows, b0.clamp(max=127)], new)
    slot = ((new & 255) * 5 + (new >> 24) * 11) & 127
    return new, slot


def sequential_decode_plain(lo, hi, totals, colch: int = 3):
    """Plain PyTorch K9 (see ``sequential_decode``)."""
    bsz, mo = lo.shape
    dev = lo.device
    w_all = lo.long() & 0xFFFFFFFF
    a_all = None if colch == 1 else hi.long() & 255
    rows = torch.arange(bsz, device=dev)
    px = torch.full((bsz,), _INIT, dtype=torch.long, device=dev)
    tab = torch.zeros((bsz, 128 if colch == 1 else 64), dtype=torch.long,
                      device=dev)
    out = torch.zeros((bsz, mo), dtype=torch.long, device=dev)
    tot = totals.to(device=dev, dtype=torch.long)
    for j in range(min(int(tot.max()), mo) if bsz else 0):
        if colch == 1:
            new, slot = _mono_step(px, w_all[:, j], tab, rows)
        else:
            new, slot = _color_step(px, w_all[:, j], a_all[:, j], tab, rows)
        live = j < tot
        px = torch.where(live, new, px)
        tab[rows, slot] = torch.where(live, px, tab[rows, slot])
        out[:, j] = torch.where(live, px, 0)
    return to_i32(out)


def sequential_decode(lo, hi, totals, colch: int = 3):
    """K9. lo: (B, mo) int32, bytes 0-3 of each op (byte 0 the tag); hi:
    (B, mo) int32, byte 4 (the alpha of a color RGBA op; None for colch 1,
    whose ops are at most 3 bytes); totals: (B,) ops per row; colch: 3
    (color step, 64 slots) or 1 (mono step, 128 slots). Returns (B, mo)
    int32: the packed pixel after each op (the decoder's running value,
    INDEX reads resolved sequentially; mono: gray | alpha << 24), 0 past a
    row's total.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if colch not in (1, 3):
        raise ValueError("colch must be 1 or 3")
    if lo.dim() != 2 or lo.dtype != torch.int32:
        raise ValueError("lo must be a (B, mo) int32 tensor")
    if colch == 3 and (hi is None or hi.shape != lo.shape
                       or hi.dtype != torch.int32):
        raise ValueError("hi must match lo: (B, mo) int32")
    bsz, mo = lo.shape
    if totals.shape != (bsz,):
        raise ValueError("totals must be (B,)")
    dev = lo.device
    if not lo.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return sequential_decode_plain(lo, hi, totals, colch)
    out = torch.zeros((bsz, mo), dtype=torch.int32, device=dev)
    P = _build.ptr
    trace.count("kernels.launches.K9.mono" if colch == 1
                else "kernels.launches.K9")
    _build.launch(
        "sequential", "k9_sequential_decode", dev,
        P(lo.contiguous()), P(None if colch == 1 else hi.contiguous()),
        P(totals.to(dtype=torch.int32, device=dev).contiguous()), bsz, mo,
        colch, P(out))
    return out
