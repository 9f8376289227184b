"""K10: sequential decode of SQOA streams that hold OP_REF.

Port of ``seqoia_tpu/codec/decode_jax.py:decode_stream_ref``, the JAX
package's ``lax.scan`` over output pixels that follows the reference's
non-monotonic cursor: REF replays 2-4 opcode bytes from a back-window of up
to 31 bytes, then teleports the cursor (seqoia.h:729-738, SQOA_NEXT at
seqoia.h:418). It is no Pallas kernel. The kernel is ``csrc/ref.cu`` (see
its header for the three kinds of fetch, what bounds it on the H100 and its
design: one block a stream, the stream staged in shared memory a chunk at a
time, every byte position pre-decoded into one word, one walker that loads
one word an op outside replay windows, the pixels placed from the walker's
records). Three plain versions:

- ``ref_decode_plain`` walks the reference's automaton op by op in Python
  over a CPU tensor's bytes: the reference the kernel is held to;
- ``ref_descriptors_plain`` is the kernel's per-position descriptor table;
- ``ref_walk_plain`` is the kernel's design step by step: chunks staged into
  a ring of stages as far ahead as the freed chunks allow, the fast walk
  over the descriptors in batches bounded by the staged bytes and the
  pixels left (the cursor recovered from the descriptors' addresses), the
  byte walk on staged bytes (unchecked within REACH) or the stream's, the
  records and their placement by tiles. Its chunk size is a parameter, so
  that the tests meet the chunk edges at small sizes.

The walk stops at ``n_pixels``, as the reference's loop does: the JAX scan
runs to its power-of-two ``n_max`` and so also flags a REF that starts
before the stream in an op past the last pixel, which the reference never
reads.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build

HEADER = 14  # header bytes; the start byte follows
OP_ALPHA, OP_LUMA, OP_BIGRUN, OP_RGB, OP_RGBA = 0x60, 0x80, 0xFD, 0xFE, 0xFF
MAXRUN = 512
INIT = 0xFF000000  # r = g = b = 0, a = 255

# csrc/ref.cu's constants: bytes a chunk, ring stages, the largest image
# whose pixels the walking block places itself, and the records a tile of
# that placement and of k10_fill's
CHUNK, STAGES, SMALL, WALK_TILE, FILL_TILE = 2048, 4, 1 << 16, 128, 256
# the byte walk reads within REACH bytes of its op's start: where that much
# around the cursor is staged, the kernel reads the byte ring unchecked
REACH = 48
# a descriptor, four 32-bit words: x = the next op's descriptor's shared
# address (a REF's: its own); y = the op's pixels (run + 1), or a REF's tag
# << 16 and the slow bit; z = the byte-wise addend; w = the keep mask
SLOW = 1 << 31


def _check(data, chunks_len, n_pixels, colch, out_ch, n_max):
    if colch not in (1, 3):
        raise ValueError("colch must be 1 or 3")
    if out_ch not in (1, 2, 3, 4):
        raise ValueError("out_ch must be 1-4")
    if data.dim() != 1 or data.dtype != torch.uint8 or data.numel() == 0:
        raise ValueError("data must be a non-empty (m,) uint8 tensor")
    if not 0 <= n_pixels <= n_max:
        raise ValueError("n_pixels must lie in [0, n_max]")
    if n_pixels >= 2 ** 31:
        raise ValueError("n_pixels must be below 2**31 (the kernel's "
                         "records hold 32-bit pixel indices)")
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


def ref_descriptors_plain(data, *, colch: int, chunk: int = CHUNK,
                          stages: int = STAGES, first: int = 0,
                          base: int = 0):
    """K10's descriptor of every byte position of ``data`` (a (m,) uint8
    tensor whose byte i lies at stream position first + i): what the op
    that starts there does when no replay window is near, its bytes read in
    a line, clamped to data's last. Returns a (m, 4) int64 tensor of the
    four 32-bit words (see SLOW): x the next op's descriptor's address in
    a ring of ``chunk * stages`` 16-byte words at ``base``; y the op's
    pixels, or a REF's tag and the slow flag; z the byte-wise addend to the
    pixel (r | g << 8 | b << 16 | a << 24, mono: the gray in r, g and b); w
    the keep mask."""
    ring = chunk * stages
    m = data.numel()
    idx = torch.arange(m)
    by = data.long()
    bj = [by[torch.clamp(idx + j, max=m - 1)] for j in range(6)]
    b0, b1 = bj[0], bj[1]
    rgb, rgba = b0 == OP_RGB, b0 == OP_RGBA
    lit = rgb | rgba
    luma = (b0 & 0xC0) == OP_LUMA
    vg = (b0 & 63) - 32
    if colch == 3:
        lit_add = (b1 | (bj[2] << 8) | (bj[3] << 16)
                   | torch.where(rgba, bj[4] << 24, 0))
        lit_ops = 3 + rgba.long()
        luma_add = (((vg - 8 + (b1 >> 4)) & 255) | ((vg & 255) << 8)
                    | (((vg - 8 + (b1 & 15)) & 255) << 16))
        luma_ops = 1
    else:
        lit_add = b1 * 0x010101 | torch.where(rgba, bj[2] << 24, 0)
        lit_ops = 1 + rgba.long()
        luma_add = (vg & 255) * 0x010101
        luma_ops = 0
    add = torch.where(lit, lit_add, torch.where(luma, luma_add, 0))
    length = 1 + torch.where(lit, lit_ops, torch.where(luma, luma_ops, 0))
    run = torch.where(b0 == OP_BIGRUN, MAXRUN - 1,
                      torch.where(lit | luma, 0, b0 & 63))
    keep = torch.where(rgba, 0, torch.where(rgb, 0xFF000000, 0xFFFFFFFF))
    if colch == 3:  # the alpha modifier: peeked and consumed alike
        peek = torch.stack(bj, 1).gather(1, length[:, None])[:, 0]
        mod = (peek >= OP_ALPHA) & (peek < OP_LUMA)
        add = (add + torch.where(mod, ((peek & 31) - 16) << 24, 0)) \
            & 0xFFFFFFFF
        length = length + mod.long()
    slow = b0 < OP_ALPHA
    at = first + idx
    nxt = base + ((at + torch.where(slow, 0, length)) % ring) * 16
    meta = torch.where(slow, SLOW | (b0 << 16), run + 1)
    return torch.stack([nxt, meta, torch.where(slow, 0, add),
                        torch.where(slow, 0, keep)], 1)


def _apply(v, keep, add):
    """(v & keep) + add, byte-wise mod 256: a descriptor's pixel update."""
    vk = v & keep
    return sum((((vk >> s) + (add >> s)) & 255) << s for s in (0, 8, 16, 24))


def _place_plain(ts, vs, n_pixels, out_ch, n_max, tile):
    """K10's placement: the pixels from the records (first pixel, value),
    a tile of ``tile`` records at a time, each pixel the value of the last
    record at or before it; in the out_ch layout, 0 past n_pixels."""
    t, v = torch.tensor(ts), torch.tensor(vs)
    val = torch.empty(n_pixels, dtype=torch.int64)
    for i0 in range(0, len(ts), tile):
        cnt = min(tile, len(ts) - i0)
        end = ts[i0 + cnt] if i0 + cnt < len(ts) else n_pixels
        p = torch.arange(ts[i0], end)
        k = torch.searchsorted(t[i0: i0 + cnt], p, right=True) - 1
        val[ts[i0]: end] = v[i0: i0 + cnt][k]
    r, g, bl, a = ((val >> s) & 255 for s in (0, 8, 16, 24))
    cols = {1: [g], 2: [g, a], 3: [r, g, bl], 4: [r, g, bl, a]}[out_ch]
    out = torch.zeros(n_max * out_ch, dtype=torch.uint8)
    out[: n_pixels * out_ch] = torch.stack(cols, 1).reshape(-1).to(
        torch.uint8)
    return out


def ref_walk_plain(data, chunks_len: int, n_pixels: int, *, colch: int,
                   out_ch: int, n_max: int, chunk: int = CHUNK,
                   stages: int = STAGES):
    """Plain K10 by the kernel's design (see the module docstring): returns
    what ``ref_decode_plain`` returns. ``chunk`` and ``stages`` are powers
    of two. It asserts the kernel's invariants: a stage is refilled only
    once its chunk is freed, a chunk is walked only once staged, a batch
    stays inside its bounds, an unchecked byte read lies in a staged chunk
    not yet freed, and every descriptor and staged byte the walker reads is
    of the position it asks for."""
    _check(data, chunks_len, n_pixels, colch, out_ch, n_max)
    if chunk < 64 or chunk & (chunk - 1) or stages < 2 or \
            stages & (stages - 1):
        raise ValueError("chunk (>= 64) and stages (>= 2) are powers of two")
    ring = chunk * stages
    b = data.tolist()
    last = len(b) - 1
    nchunks = -(-chunks_len // chunk)
    desc = [None] * ring  # (x, meta, add, keep, the position it describes)
    held = [-1] * stages  # the chunk each stage holds
    ring_b = [(0, None)] * ring  # (byte, the position it holds)
    st = dict(freed=0, verified=-1, staged=0, checked=True)

    def produce():  # the producers, as far ahead as the freed chunks allow
        while st["staged"] < min(nchunks, st["freed"] + stages):
            k = st["staged"]
            s = k % stages
            assert held[s] < st["freed"], "a stage refilled before its free"
            base = k * chunk
            span = data[torch.clamp(torch.arange(base, base + chunk + 8),
                                    max=last)]
            ring_b[s * chunk: (s + 1) * chunk] = zip(
                span.tolist()[:chunk], range(base, base + chunk))
            words = ref_descriptors_plain(span, colch=colch, chunk=chunk,
                                          stages=stages, first=base).tolist()
            for i in range(min(chunk, chunks_len - base)):
                desc[s * chunk + i] = (*words[i], base + i)
            held[s] = k
            st["staged"] += 1

    def fetch(q):  # staged where resident, else the stream itself
        if not st["checked"]:  # the ring, as the kernel reads it unchecked
            k = max(q, 0) // chunk
            assert (st["freed"] == 0 or k >= st["freed"]) and \
                k <= st["verified"], "an unchecked read out of the staged bytes"
            byte, at = ring_b[max(q, 0) % ring]
            assert at == max(q, 0)
            return byte
        q = min(max(q, 0), last)
        k = q // chunk
        if st["freed"] <= k <= st["verified"]:
            byte, at = ring_b[q % ring]
            assert held[k % stages] == k and at == q
            return byte
        return b[q]

    pos, rend, res = HEADER + 1, -1, 0
    v, t, bad = INIT, 0, False
    ts, vs = [0], [INIT]  # the records: an op's first pixel and value

    def nxt():  # replay-aware: SQOA_NEXT
        nonlocal pos
        q = res + 1 if pos == rend else pos
        pos = q if pos == rend else q + 1
        return fetch(q)

    produce()
    while t < n_pixels and pos < chunks_len:
        kp = pos // chunk
        if kp > st["verified"]:
            if kp - 1 > st["freed"]:
                st["freed"] = kp - 1
                produce()
            while st["verified"] < kp:
                assert held[(st["verified"] + 1) % stages] == \
                    st["verified"] + 1, "a chunk walked before it was staged"
                st["verified"] += 1
        tag = None
        if pos > rend and kp >= st["freed"]:  # the fast path
            lim = min((st["verified"] + 1) * chunk, chunks_len)
            a0 = a = pos % ring
            # a batch: ops that can neither leave the staged chunks nor pass
            # n_pixels, stopped only by a REF's word; pos from the addresses
            nb = min((lim - pos) // 6, (n_pixels - t) // 512) & ~3
            steps = nb if nb > 0 else None  # None: the checked tail
            pos0, i = pos, 0
            while steps is None or i < steps:
                if steps is None and (pos >= lim or t >= n_pixels):
                    break
                assert pos < lim and t < n_pixels, "a batch past its bound"
                x, meta, add, keep, at = desc[a]
                assert at == pos, "a stale descriptor"
                if meta & SLOW:
                    tag = (meta >> 16) & 255  # a REF's word: its tag
                    break
                na = x // 16
                v = _apply(v, keep, add)
                ts.append(t)
                vs.append(v)
                t += meta
                pos += (na - a) % ring
                a, i = na, i + 1
            assert pos == pos0 + (a - a0) % ring
            if tag is None:
                continue
        # the byte walk: the reference's step for one op, unchecked where
        # REACH bytes around the cursor are staged
        st["checked"] = not ((st["freed"] == 0 or
                              pos - REACH >= st["freed"] * chunk) and
                             pos + REACH < (st["verified"] + 1) * chunk)
        r, g, bl, al = ((v >> s) & 255 for s in (0, 8, 16, 24))
        b1 = nxt()
        assert tag is None or tag == b1, "a REF's word holds another tag"
        if b1 < OP_ALPHA:
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
                al = nxt()
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
        if colch == 3:
            if OP_ALPHA <= fetch(pos) < OP_LUMA:
                al = (al + (nxt() & 0x1F) - 16) & 255
        else:
            r = bl = g
        v = r | g << 8 | bl << 16 | al << 24
        ts.append(t)
        vs.append(v)
        t += run + 1
    tile = WALK_TILE if n_pixels <= SMALL else FILL_TILE
    return (_place_plain(ts, vs, n_pixels, out_ch, n_max, tile),
            torch.tensor(bad), torch.tensor(len(ts) - 1, dtype=torch.int32))


def ref_decode(data, chunks_len: int, n_pixels: int, *, colch: int,
               out_ch: int, n_max: int):
    """K10. data: (m,) uint8, the whole SQOA stream (header, start byte,
    ops, end marker) zero-padded to m bytes; chunks_len: the stream's length
    less the 8-byte marker; n_pixels <= n_max, below 2**31; colch: 3
    (color) or 1 (mono); out_ch: 1-4, the channels asked for. Returns
    ((n_max * out_ch,) uint8 pixels in the out_ch layout of
    ``decode_jax._format_pixels``, 0 past n_pixels; a 0-d bool tensor
    ``err``, set where a REF's window starts before the stream; a 0-d int32
    tensor, the ops walked).

    A CUDA tensor runs the kernel (and waits for it: it raises if a wait in
    the kernel ran out of its clock budget); a CPU tensor runs the plain
    version."""
    _check(data, chunks_len, n_pixels, colch, out_ch, n_max)
    dev = data.device
    if not data.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return ref_decode_plain(data, chunks_len, n_pixels, colch=colch,
                                out_ch=out_ch, n_max=n_max)
    data = data.contiguous()
    out = torch.zeros(n_max * out_ch, dtype=torch.uint8, device=dev)
    rec = torch.empty(2 * (n_pixels + 1), dtype=torch.int32, device=dev)
    stat = torch.empty(4, dtype=torch.int32, device=dev)  # err, ops, fault
    trace.count("kernels.launches.K10")
    _build.launch(
        "ref", "k10_ref_decode", dev,
        _build.ptr(data), data.numel(), chunks_len, n_pixels, colch, out_ch,
        _build.ptr(out), _build.ptr(rec), _build.ptr(stat))
    trace.host_sync("ref_fault")
    fault = int(stat[3])
    if fault:
        raise RuntimeError(f"k10_ref_decode: a wait in the kernel ran out "
                           f"of its budget (fault word {fault})")
    return out, stat[0] != 0, stat[1]
