"""The benchmark's plain SQOA / ``.qoi`` codec.

Written from the wire format (the reference header ``seqoia.h``: ops at
lines 65-282, constants at 398-439, the encoder at 465-642, the decoder at
663-790), independently of the code under test: it imports nothing of the
program. Two halves:

* ``encode``: the encoder as whole-image tensor operations (PyTorch, on any
  device), so it makes the streams of a 120 Mpx image in well under a
  second on a card. Every op the sequential encoder would emit is decided
  per pixel from the pixel, the one before it, the length of the run that
  ends at it and (``.qoi`` only) the last earlier op pixel of its index
  slot; the bytes are then scattered to their exclusive-cumsum offsets.
* ``decode``: the decoder as the plain op-by-op walk, in Python. It is the
  semantics the encoder is held to in the benchmark's tests; it is far too
  slow for a timed size (about 10 us a pixel), and the benchmark never runs
  it on one: the codec is lossless, so the reference's answer for a stream
  it made is the image it made it from.

Both follow the reference in its quirks: a trailing run of any length is
one BIGRUN byte (seqoia.h:640-642), mono pixels keep r = b = 0 so that a
mono LUMA needs -dg in [-8, 7], and ``.qoi`` streams insert every missed
pixel into the 64-slot index (seqoia.h:571).
"""

from __future__ import annotations

import struct

import torch

MAGIC_SQOA, MAGIC_QOI = b"Sqoa", b"qoif"
START_BYTE = 0x31
PADDING = bytes((0, 0, 0, 0, 0, 0, 0, 1))
HEADER_SIZE = 14
SQOA_MAXRUN, QOI_MAXRUN = 512, 62
OP_ALPHA, OP_LUMA, OP_RUN = 0x60, 0x80, 0xC0
OP_BIGRUN, OP_RGB, OP_RGBA = 0xFD, 0xFE, 0xFF
QOI_DIFF = 0x40
PIXELS_MAX = 400_000_000


def header(width: int, height: int, channels: int, colorspace: int = 0,
           qoi: bool = False) -> bytes:
    """The 14-byte header (channels as stored: 1-4) and, for SQOA, the
    start byte (seqoia.h:497-514)."""
    out = (MAGIC_QOI if qoi else MAGIC_SQOA) + struct.pack(
        ">IIBB", width, height, channels, colorspace)
    return out if qoi else out + bytes((START_BYTE,))


def _i8(x):
    """int8 wraparound of an integer tensor, as a signed value."""
    return ((x + 128) & 255) - 128


def encode(pixels: torch.Tensor, width: int, height: int, channels: int,
           colorspace: int = 0, qoi: bool = False) -> torch.Tensor:
    """The file bytes of one image as a uint8 tensor on ``pixels.device``.

    pixels: (width * height * channels,) or any shape of that many uint8,
    interleaved; channels 1 (gray), 2 (gray + alpha), 3 (RGB), 4 (RGBA).
    ``qoi`` writes a ``.qoi`` stream, which holds no gray image."""
    if channels not in (1, 2, 3, 4) or width < 1 or height < 1:
        raise ValueError("channels must be 1-4 and the size positive")
    if qoi and channels < 3:
        raise ValueError(".qoi holds no gray image")
    dev = pixels.device
    n = width * height
    colch = 1 if channels < 3 else 3
    has_alpha = channels % 2 == 0
    px = pixels.reshape(n, channels).to(torch.int64)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    if colch == 3:
        r, g, b = px[:, 0], px[:, 1], px[:, 2]
    else:
        r, g, b = zero, px[:, 0], zero
    a = px[:, colch] if has_alpha else torch.full_like(zero, 255)
    word = r | (g << 8) | (b << 16) | (a << 24)
    # the pixel before each, the first one's the initial (0, 0, 0, 255)
    init = torch.tensor([255 << 24], dtype=torch.int64, device=dev)
    prev = torch.cat([init, word[:-1]])
    op = word != prev
    pos = torch.nonzero(op).squeeze(1)          # the op pixels, in order
    k = pos.numel()

    # --- runs: the same-pixels before each op pixel, and after the last ----
    max_run = QOI_MAXRUN if qoi else SQOA_MAXRUN
    before = torch.cat([torch.tensor([-1], device=dev), pos])[:k]
    run = pos - before - 1                       # run flushed at each op
    tail = n - 1 - (int(pos[-1]) if k else -1)
    big = run // max_run                         # BIGRUNs while it ran
    rem = run % max_run
    # the flush of the rest (seqoia.h:554-561): RUN|60 for each full 61,
    # then RUN|(rest - 1); .qoi's rest is below 62, so one byte
    full = torch.where(rem > 0, (rem - 1) // 61, 0)
    last = rem - 61 * full                       # 1-61, or 0: no byte
    run_len = big + full + (rem > 0).to(torch.int64)

    # --- the op of each op pixel -------------------------------------------
    wr, wg, wb, wa = r[pos], g[pos], b[pos], a[pos]
    pw = prev[pos]
    pr, pg, pb, pa = pw & 255, (pw >> 8) & 255, (pw >> 16) & 255, pw >> 24
    dr, dg, db, da = _i8(wr - pr), _i8(wg - pg), _i8(wb - pb), _i8(wa - pa)
    dr_dg, db_dg = _i8(dr - dg), _i8(db - dg)
    achg = da != 0
    ops = torch.zeros((k, 5), dtype=torch.int64, device=dev)
    op_len = torch.zeros(k, dtype=torch.int64, device=dev)
    todo = torch.ones(k, dtype=torch.bool, device=dev)

    def put(mask, cols):
        """Write op bytes ``cols`` (tensors or ints) where ``mask``."""
        nonlocal todo
        mask = mask & todo
        for j, c in enumerate(cols):
            ops[:, j] = torch.where(mask, c, ops[:, j])
        op_len.masked_fill_(mask, len(cols))
        todo = todo & ~mask

    if qoi:
        slot = (wr * 3 + wg * 5 + wb * 7 + wa * 11) % 64
        # the index holds, per slot, the last op pixel written to it: sort
        # the op pixels by slot (stably), each one's predecessor in its slot
        order = torch.sort(slot, stable=True).indices
        s_sorted, w_sorted = slot[order], word[pos][order]
        same_slot = torch.cat([torch.tensor([False], device=dev),
                               s_sorted[1:] == s_sorted[:-1]])
        held = torch.where(same_slot, torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev), w_sorted[:-1]]), 0)
        table = torch.empty_like(held)
        table[order] = held                      # 0: a slot not yet written
        put(table == word[pos], [slot])
        put(achg, [OP_RGBA, wr, wg, wb, wa])
        small = ((dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1)
                 & (db >= -2) & (db <= 1))
        put(small, [QOI_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)])
    elif colch == 1:
        put(achg, [OP_RGBA, wg, wa])
    luma = ((dr_dg >= -8) & (dr_dg <= 7) & (dg >= -32) & (dg <= 31)
            & (db_dg >= -8) & (db_dg <= 7) & (da >= -16) & (da <= 15))
    if colch == 3:
        lo = ((dr_dg + 8) << 4) | (db_dg + 8)
        put(luma & achg, [OP_LUMA | (dg + 32), lo, OP_ALPHA | (da + 16)])
        put(luma, [OP_LUMA | (dg + 32), lo])
        put(achg, [OP_RGBA, wr, wg, wb, wa])
        put(todo, [OP_RGB, wr, wg, wb])
    else:
        put(luma, [OP_LUMA | (dg + 32)])
        put(todo, [OP_RGB, wg])

    # --- lay the bytes out -------------------------------------------------
    tail_big = tail // max_run
    tail_len = tail_big + int(tail % max_run > 0)
    span = run_len + op_len
    start = torch.cumsum(span, 0) - span
    body = int(span.sum()) + tail_len
    hdr = header(width, height, channels, colorspace, qoi)
    out = torch.zeros(len(hdr) + body + len(PADDING), dtype=torch.uint8,
                      device=dev)
    out[: len(hdr)] = torch.frombuffer(bytearray(hdr), dtype=torch.uint8).to(
        dev)
    base = len(hdr)
    n_run = int(run_len.sum())
    if n_run:
        owner = torch.repeat_interleave(torch.arange(k, device=dev), run_len)
        j = torch.arange(n_run, device=dev) - (
            torch.cumsum(run_len, 0) - run_len)[owner]
        val = torch.where(
            j < big[owner], OP_BIGRUN,
            torch.where(j < big[owner] + full[owner], OP_RUN | 60,
                        OP_RUN | (last[owner] - 1)))
        out[base + start[owner] + j] = val.to(torch.uint8)
    cols = torch.arange(5, device=dev)
    keep = cols[None, :] < op_len[:, None]
    at = (base + start + run_len)[:, None] + cols[None, :]
    out[at[keep]] = ops[keep].to(torch.uint8)
    end = base + body - tail_len
    out[end: end + tail_len] = OP_BIGRUN
    out[base + body + 7] = 1
    return out


def decode(data: bytes, channels: int = 0):
    """The plain op-by-op decode (seqoia.h:663-790). Returns (bytearray of
    width * height * out channels, (width, height, channels, colorspace,
    qoi)) or (None, None) for a malformed header."""
    if len(data) < HEADER_SIZE + len(PADDING) or not 0 <= channels <= 4:
        return None, None
    magic = data[:4]
    width, height = struct.unpack(">II", data[4:12])
    hdr_ch, colorspace = data[12], data[13]
    qoi = data[14] != START_BYTE
    if (magic not in (MAGIC_SQOA, MAGIC_QOI) or (magic == MAGIC_QOI
                                                  and not qoi)
            or width == 0 or height == 0 or not 1 <= hdr_ch <= 6
            or colorspace > 1 or height >= PIXELS_MAX // width):
        return None, None
    colch = 1 if hdr_ch < 3 else 3
    index_size = 128 if colch == 1 else 64
    out_ch = channels or colch + (1 - hdr_ch % 2)
    add_alpha = out_ch % 2 == 0
    p = HEADER_SIZE + (0 if qoi else 1)
    end = len(data) - len(PADDING)
    table = [(0, 0, 0, 0)] * 128
    r, g, b, a = 0, 0, 0, 255
    out = bytearray(width * height * out_ch)
    run = 0
    replay_end, resume = -1, 0

    def nxt():
        nonlocal p
        if p == replay_end:
            p = resume + 1
            return data[p]
        p += 1
        return data[p - 1]

    for o in range(0, len(out), out_ch):
        if run:
            run -= 1
        elif p < end:
            b1 = nxt()
            if not qoi and b1 < OP_ALPHA:        # REF (seqoia.h:729-738)
                resume, replay_end = p, p - (b1 & 31)
                p = replay_end - 2 - (b1 >> 5)
                if p < 0:
                    return None, None
                b1 = data[p]
                p += 1
            if b1 in (OP_RGB, OP_RGBA):
                if colch == 3:
                    r, g, b = nxt(), nxt(), nxt()
                else:
                    g = nxt()
                if b1 == OP_RGBA:
                    a = nxt()
            elif qoi and b1 < index_size:
                r, g, b, a = table[b1]
            elif qoi and b1 & 0xC0 == QOI_DIFF:
                r = (r + ((b1 >> 4) & 3) - 2) & 255
                g = (g + ((b1 >> 2) & 3) - 2) & 255
                b = (b + (b1 & 3) - 2) & 255
            elif b1 & 0xC0 == OP_LUMA:
                dg = (b1 & 0x3F) - 32
                g = (g + dg) & 255
                if colch == 3:
                    b2 = nxt()
                    r = (r + dg - 8 + ((b2 >> 4) & 15)) & 255
                    b = (b + dg - 8 + (b2 & 15)) & 255
            elif not qoi and b1 == OP_BIGRUN:
                run = SQOA_MAXRUN - 1
            else:
                run = b1 & 0x3F
            if (not qoi and colch == 3
                    and OP_ALPHA <= data[p] < OP_LUMA):
                a = (a + (nxt() & 31) - 16) & 255
            if qoi:
                table[(r * 3 + g * 5 + b * 7 + a * 11) % index_size] = (
                    r, g, b, a)
        if out_ch >= 3 and colch == 3:
            out[o: o + 3] = bytes((r, g, b))
        else:
            out[o] = g
            if out_ch >= 3:
                out[o + 1] = out[o + 2] = g
        if add_alpha:
            out[o + out_ch - 1] = a
    return out, (width, height, hdr_ch, colorspace, int(qoi))
