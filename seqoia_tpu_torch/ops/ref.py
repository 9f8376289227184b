"""K10: sequential decode of SQOA streams that hold OP_REF.

Port of ``seqoia_tpu/codec/decode_jax.py:decode_stream_ref``, the JAX
package's ``lax.scan`` over output pixels that follows the reference's
non-monotonic cursor: REF replays 2-4 opcode bytes from a back-window of up
to 31 bytes, then teleports the cursor (seqoia.h:729-738, SQOA_NEXT at
seqoia.h:418). It is no Pallas kernel. The kernel is ``csrc/ref.cu`` (see
its header for the three kinds of fetch, what bounds it on the H100 and its
design: one thread a stream); ``ref_decode_plain`` walks the same automaton
op by op in Python over a CPU tensor's bytes.

The walk stops at ``n_pixels``, as the reference's loop does: the JAX scan
runs to its power-of-two ``n_max`` and so also flags a REF that starts
before the stream in an op past the last pixel, which the reference never
reads.
"""

from __future__ import annotations

import torch

from . import _build

HEADER = 14  # header bytes; the start byte follows
OP_ALPHA, OP_LUMA, OP_BIGRUN, OP_RGB, OP_RGBA = 0x60, 0x80, 0xFD, 0xFE, 0xFF
MAXRUN = 512


def _check(data, chunks_len, n_pixels, colch, out_ch, n_max):
    if colch not in (1, 3):
        raise ValueError("colch must be 1 or 3")
    if out_ch not in (1, 2, 3, 4):
        raise ValueError("out_ch must be 1-4")
    if data.dim() != 1 or data.dtype != torch.uint8 or data.numel() == 0:
        raise ValueError("data must be a non-empty (m,) uint8 tensor")
    if not 0 <= n_pixels <= n_max:
        raise ValueError("n_pixels must lie in [0, n_max]")
    if not 0 <= chunks_len < 2 ** 31 or data.numel() >= 2 ** 31:
        raise ValueError("the stream must be shorter than 2**31 bytes")


def ref_decode_plain(data, chunks_len: int, n_pixels: int, *, colch: int,
                     out_ch: int, n_max: int):
    """Plain K10 (see ``ref_decode``): the reference's walk, op by op."""
    _check(data, chunks_len, n_pixels, colch, out_ch, n_max)
    b = data.tolist()
    last = len(b) - 1

    def fetch(p):
        return b[min(max(p, 0), last)]

    pos, rend, res = HEADER + 1, -1, 0
    ops = 0

    def nxt():  # replay-aware: SQOA_NEXT
        nonlocal pos
        if pos == rend:
            pos = res + 1
            return fetch(pos)
        pos += 1
        return fetch(pos - 1)

    r = g = bl = 0
    a = 255
    bad = False
    out = bytearray(n_max * out_ch)
    t = 0
    while t < n_pixels:
        if pos >= chunks_len:
            n = n_pixels - t
        else:
            b1 = nxt()
            ops += 1
            if b1 < OP_ALPHA:  # REF: the replacement byte is a raw read
                res, rend = pos, pos - (b1 & 31)
                start = rend - 2 - (b1 >> 5)
                bad |= start < 0
                b1, pos = fetch(start), start + 1
            run = 0
            if b1 in (OP_RGB, OP_RGBA):
                if colch == 3:
                    r, g, bl = nxt(), nxt(), nxt()
                else:
                    g = nxt()
                if b1 == OP_RGBA:
                    a = nxt()
            elif b1 & 0xC0 == OP_LUMA:
                vg = (b1 & 0x3F) - 32
                g = (g + vg) & 255
                if colch == 3:
                    o = nxt()
                    r = (r + vg - 8 + ((o >> 4) & 15)) & 255
                    bl = (bl + vg - 8 + (o & 15)) & 255
            elif b1 == OP_BIGRUN:
                run = MAXRUN - 1
            else:
                run = b1 & 0x3F
            if colch == 3 and OP_ALPHA <= fetch(pos) < OP_LUMA:
                a = (a + (nxt() & 0x1F) - 16) & 255  # raw peek, then next
            n = min(run + 1, n_pixels - t)
        cols = [r, g, bl] if colch == 3 else [g, g, g]
        px = bytes(cols[:out_ch] if out_ch >= 3 else [g])
        if out_ch in (2, 4):
            px += bytes([a])
        out[t * out_ch: (t + n) * out_ch] = px * n
        t += n
    return (torch.frombuffer(out, dtype=torch.uint8), torch.tensor(bad),
            torch.tensor(ops, dtype=torch.int32))


def ref_decode(data, chunks_len: int, n_pixels: int, *, colch: int,
               out_ch: int, n_max: int):
    """K10. data: (m,) uint8, the whole SQOA stream (header, start byte,
    ops, end marker) zero-padded to m bytes; chunks_len: the stream's length
    less the 8-byte marker; n_pixels <= n_max; colch: 3 (color) or 1
    (mono); out_ch: 1-4, the channels asked for. Returns ((n_max * out_ch,)
    uint8 pixels in the out_ch layout of ``decode_jax._format_pixels``, 0
    past n_pixels; a 0-d bool tensor ``err``, set where a REF's window
    starts before the stream; a 0-d int32 tensor, the ops walked).

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    _check(data, chunks_len, n_pixels, colch, out_ch, n_max)
    dev = data.device
    if not data.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return ref_decode_plain(data, chunks_len, n_pixels, colch=colch,
                                out_ch=out_ch, n_max=n_max)
    out = torch.zeros(n_max * out_ch, dtype=torch.uint8, device=dev)
    stat = torch.empty(2, dtype=torch.int32, device=dev)  # err, ops walked
    lib = _build.load("ref")
    ref_decode.launches += 1
    rc = lib.k10_ref_decode(
        _build.ptr(data.contiguous()), data.numel(), chunks_len, n_pixels,
        colch, out_ch, _build.ptr(out), _build.ptr(stat),
        _build.stream_ptr(dev))
    _build.check(rc, "k10_ref_decode")
    return out, stat[0] != 0, stat[1]


ref_decode.launches = 0
