"""K1: SQOA decode front-end, bytes -> compacted op stream.

Port of ``seqoia_tpu/ops/pallas_frontend.py:decode_front_compact``. The
kernel is ``csrc/frontend.cu``: one launch whose 4096-byte tiles are chained
by three decoupled look-backs (automaton map, channel sum, op and pixel
counts); in segment mode one launch whose tiles scan their segments with
segmented block scans (or look back over a long segment's tiles) and rank
the kept ops by a look-back over the packed row. See its header for the
design and what bounds it on the H100. ``decode_front_plain`` is the same
function in plain PyTorch, in the form of the JAX package's XLA path
(``decode_v2._tokenize`` / ``_npix_table`` / ``_reconstruct``), with the
fused front's mode semantics:

* ``"alpha"``: an op absorbs one following alpha-range byte (the
  reference's alpha peek, seqoia.h:777-783) into its token length;
* ``"noalpha"`` (header channels == 3): alpha-range and RGBA tokens flag
  the stream foreign; RGBA parses as one byte. So does an alpha-range byte
  where the reference peeks after the stream's last op: the first
  position at or past ``chunks_len`` where the automaton is at state 0
  (in the end marker, or past a last op whose body runs into it);
* ``"mono"``: LUMA is 1 byte, RGB 2, RGBA 3, no alpha peek; gray rides
  byte 0 of the packed payload and alpha byte 3.

Any unmatched byte is a run of ``(b & 63) + 1`` pixels. Outputs: keys (the
op's first pixel) and payloads (packed RGBA after the op), each (B, M)
int32 and valid below ``totals`` = the number of ops whose key < n_max;
``has_ref`` (B,) int32 flags REF/foreign streams for the host fallback.

Segment mode (``seg``, ``seg_px``): a row packs M/seg small images, image j
in bytes [j*seg, (j+1)*seg) with its header, zero-padded, each decoding to
exactly ``seg_px`` pixels. ``chunks_len`` is then (B, M/seg), relative to
the segment (0: an empty segment, which emits nothing); keys come out
global (j*seg_px + the offset in the image), an op whose offset reaches
``seg_px`` is dropped, the ops of a row's segments are compacted together,
and ``totals`` and ``has_ref`` stay per packed row. ``seg`` is a power of
two with ``32768 % seg == 0`` and ``seg % 128 == 0`` (the JAX package's
contract); a 4096-byte tile of the kernel holds 4096/seg whole segments,
or a longer segment spans seg/4096 tiles.
"""

from __future__ import annotations

import torch

from .. import spec
from ..utils import trace
from . import _build
from ._plain import compact_rows, hillis_steele, shift_left, to_i32

MODES = {"alpha": 0, "noalpha": 1, "mono": 2}

_HDR1 = spec.HEADER_SIZE + 1
_IDENT6 = sum(e << (3 * e) for e in range(6))
_BASE6 = sum((e - 1) << (3 * e) for e in range(1, 6))


def _compose6(left, right):
    (l,), (r,) = left, right
    out = torch.zeros_like(l)
    for e in range(6):
        fe = (l >> (3 * e)) & 7
        out = out | (((r >> (3 * fe)) & 7) << (3 * e))
    return (out,)


def _swar_add(a, b):
    return ((a & 0x7F7F7F7F) + (b & 0x7F7F7F7F)) ^ ((a ^ b) & 0x80808080)


def _chan_combine(left, right):
    (lv, lf), (rv, rf) = left, right
    s = _swar_add(lv, rv)
    m = torch.where((rf & 1) == 1, 0x00FFFFFF, 0) | torch.where(
        (rf & 2) == 2, 0xFF000000, 0)
    return (rv & m) | (s & (m ^ 0xFFFFFFFF)), (lf | rf) & 3


TILE = 4096  # bytes a tile (a block) of the kernel


def scratch_words(bsz: int, m: int, k: int = 1) -> int:
    """int32 words of a K1 launch's scratch over (bsz, m) bytes: a 64-bit
    tile counter and, per tile, three 64-bit status words (k = 1: map,
    channel sum, op and pixel counts) or four (segment mode, k segments a
    row: the kept ops' rank, and a long segment's map, channel sum and
    pixel count)."""
    return 2 * ((3 if k == 1 else 4) * bsz * -(-m // TILE) + 1)


#: positions (rows x bytes) the plain version evaluates at once: it walks a
#: long row in blocks and carries the scans' state, so its memory does not
#: grow with the stream
_PLAIN_BLOCK = 1 << 25
#: bytes past a block that its last ops read (operands and the alpha peek)
_PLAIN_HALO = 8


def decode_front_plain(data, chunks_len, n_max: int, mode: str = "alpha",
                       block: int | None = None):
    """Plain PyTorch K1 (see module docstring). Entries past totals are 0.
    ``block``: bytes of a row evaluated at once (default: ``_PLAIN_BLOCK``
    positions over the rows); any value gives the same result."""
    bsz, m = data.shape
    dev = data.device
    if block is None:
        block = max(_PLAIN_BLOCK // max(bsz, 1), 4096)
    keys_c = torch.zeros((bsz, m), dtype=torch.int32, device=dev)
    pays_c = torch.zeros((bsz, m), dtype=torch.int32, device=dev)
    totals = [0] * bsz
    has_ref = torch.zeros(bsz, dtype=torch.bool, device=dev)
    # carried across blocks, per row: the automaton's state, the pixel
    # offset and the channel scan's running element
    zero = torch.zeros((bsz, 1), dtype=torch.int64, device=dev)
    carry = (zero, zero, (zero, zero))
    clen = chunks_len.long()[:, None]
    # no op starts at or past a row's stream end, so the blocks past the
    # longest stream hold none (the block before reads their first bytes
    # as its halo)
    live = min(m, max(int(chunks_len.max()), 0)) if bsz else 0
    for lo in range(0, live, block):
        n = min(block, live - lo)
        b = data[:, lo: lo + n + _PLAIN_HALO].long()
        keep, keys, packed, ref, carry = _front_block(
            b, lo, n, clen, n_max, mode, carry)
        has_ref |= ref
        for r in range(bsz):
            msk = keep[r]
            cnt = int(msk.sum())
            keys_c[r, totals[r]: totals[r] + cnt] = to_i32(keys[r][msk])
            pays_c[r, totals[r]: totals[r] + cnt] = to_i32(packed[r][msk])
            totals[r] += cnt
    return (keys_c, pays_c,
            torch.tensor(totals, dtype=torch.int32, device=dev),
            has_ref.to(torch.int32))


def _front_block(b, lo: int, n: int, clen, n_max: int, mode: str, carry):
    """One block of decode_front_plain: b holds the row bytes [lo, lo + n)
    and up to ``_PLAIN_HALO`` more (int64). Returns (kept-op mask, keys,
    payloads, each (B, n); the rows' foreign flags; the carry after byte
    lo + n - 1)."""
    mono, noalpha = mode == "mono", mode == "noalpha"
    state0, px0, chan0 = carry
    pos = lo + torch.arange(b.shape[-1], device=b.device)
    b1, b2, b3, b4 = (shift_left(b, k) for k in (1, 2, 3, 4))
    is_luma = (b & spec.MASK_2) == spec.OP_LUMA
    is_rgb = b == spec.OP_RGB
    is_rgba = b == spec.OP_RGBA

    # --- token automaton: 6-state skip counter, one map per byte ----------
    att = torch.zeros_like(b)
    if mono:
        lens = 1 + is_rgb.long() + 2 * is_rgba.long()
    elif noalpha:
        lens = 1 + is_luma.long() + 3 * is_rgb.long()
    else:
        lens = 1 + is_luma.long() + 3 * is_rgb.long() + 4 * is_rgba.long()
        isalpha = (b >= spec.OP_ALPHA) & (b < spec.OP_LUMA)
        ext = torch.zeros_like(b)
        for k in (1, 2, 4, 5):
            hit = (lens == k) & shift_left(isalpha.long(), k).bool()
            ext = ext + hit.long()
            att = att + torch.where(hit, (shift_left(b, k) & 31) - 16, 0)
        lens = lens + ext
    eff = torch.where(pos >= _HDR1, lens, 1)
    (incl,) = hillis_steele(((eff - 1) + _BASE6,), _compose6)
    after = (incl >> (3 * state0)) & 7  # state after each byte
    state = torch.cat([state0, after[..., :-1]], dim=-1)
    token = (state == 0) & (pos >= _HDR1) & (pos < clen)

    if noalpha:
        foreign = (b < spec.OP_LUMA) | is_rgba
    else:
        foreign = b < spec.OP_ALPHA
    has_ref = (token & foreign)[:, :n].any(dim=-1)
    if noalpha:  # the alpha peek after the last op, in the block of clen - 1
        w = b.shape[-1]
        at = clen - lo
        end = state.gather(-1, at.clamp(1, w - 1))
        q = (at + end).clamp(0, w - 1)
        peek = b.gather(-1, q)
        hit = ((at >= 1) & (at <= n) & (at + end < w) & (clen > _HDR1)
               & (peek >= spec.OP_ALPHA) & (peek < spec.OP_LUMA))
        has_ref = has_ref | hit[:, 0]

    # --- pixel counts and offsets ------------------------------------------
    npix = (b & 0x3F) + 1
    npix = torch.where(is_luma | is_rgb | is_rgba, 1, npix)
    npix = torch.where(b == spec.OP_BIGRUN, spec.SQOA_MAXRUN, npix)
    npix = torch.where(b < spec.OP_ALPHA, 1, npix)
    npix = torch.where(token, npix, 0)
    ends = px0 + torch.cumsum(npix, dim=-1)
    keys = ends - npix

    # --- channel elements and the segmented SWAR sum -----------------------
    vg = (b & 0x3F) - 32
    anchor = token & (is_rgb | is_rgba)
    anchor_a = token & is_rgba if not noalpha else torch.zeros_like(token)
    luma_op = token & is_luma
    zero = torch.zeros_like(b)
    if mono:
        r_el = torch.where(anchor, b1, torch.where(luma_op, vg, 0))
        g_el = b_el = zero
        a_el = torch.where(anchor_a, b2, 0)
    else:
        r_el = torch.where(anchor, b1, torch.where(
            luma_op, vg - 8 + ((b1 >> 4) & 15), 0))
        g_el = torch.where(anchor, b2, torch.where(luma_op, vg, 0))
        b_el = torch.where(anchor, b3, torch.where(
            luma_op, vg - 8 + (b1 & 15), 0))
        a_el = torch.where(anchor_a, b4, 0) + torch.where(token, att, 0)
    val = ((r_el & 255) | ((g_el & 255) << 8) | ((b_el & 255) << 16)
           | ((a_el & 255) << 24))
    flg = anchor.long() | (anchor_a.long() << 1)
    sv, sf = _chan_combine(chan0, hillis_steele((val, flg), _chan_combine))
    a_v = (sv >> 24) & 255
    a_v = torch.where((sf & 2) == 2, a_v, (a_v + 255) & 255)
    packed = (sv & 0x00FFFFFF) | (a_v << 24)

    keep = token & (keys < n_max)
    last = slice(n - 1, n)
    carry = (after[:, last], ends[:, last], (sv[:, last], sf[:, last]))
    return keep[:, :n], keys[:, :n], packed[:, :n], has_ref, carry


def decode_front_plain_seg(data, chunks_len, n_max: int, mode: str,
                           seg: int, seg_px: int):
    """Plain PyTorch K1 in segment mode: every segment through
    ``decode_front_plain`` as a row of its own, the keys moved to their
    image's pixels, then one compaction per packed row."""
    bsz, m = data.shape
    k = m // seg
    keys, pays, tot, ref = decode_front_plain(
        data.reshape(bsz * k, seg), chunks_len.reshape(bsz * k), seg_px, mode)
    first = (torch.arange(bsz * k, device=data.device) % k) * seg_px
    keys = keys + first[:, None].to(torch.int32)
    live = torch.arange(seg, device=data.device)[None, :] < tot[:, None]
    keys_c, pays_c = compact_rows(live.reshape(bsz, m), keys.reshape(bsz, m),
                                  pays.reshape(bsz, m))
    return (keys_c, pays_c, tot.reshape(bsz, k).sum(dim=1).to(torch.int32),
            ref.reshape(bsz, k).amax(dim=1))


def decode_front_compact(data, chunks_len, n_max: int, mode: str = "alpha",
                         seg: int | None = None, seg_px: int | None = None):
    """K1. data: (B, M) uint8; chunks_len: (B,) int32 (stream length less
    the 8-byte end marker), or (B, M/seg) in segment mode (module
    docstring), where n_max must be (M/seg) * seg_px. Returns (keys,
    payloads, totals, has_ref).

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("data must be a (B, M) uint8 tensor")
    bsz, m = data.shape
    k = 1
    if seg is not None:
        if (seg_px is None or seg <= 0 or seg & (seg - 1) or 32768 % seg
                or seg % 128 or m % seg):
            raise ValueError(
                "seg must be a power of two from 128 to 32768 that divides "
                "M, with seg_px given")
        k = m // seg
        if n_max != k * seg_px:
            raise ValueError("n_max must be (M / seg) * seg_px")
    if chunks_len.shape != ((bsz,) if seg is None else (bsz, k)):
        raise ValueError("chunks_len must be (B,), or (B, M / seg) with seg")
    if not data.is_cuda:
        if data.device.type != "cpu":
            raise ValueError(f"unsupported device {data.device}")
        if seg is not None:
            return decode_front_plain_seg(data, chunks_len, n_max, mode, seg,
                                          seg_px)
        return decode_front_plain(data, chunks_len, n_max, mode)
    dev = data.device
    data = data.contiguous()
    if seg is not None and data.data_ptr() % 16:
        data = data.clone()  # segment mode loads 16-byte vectors
    clen = chunks_len.to(device=dev, dtype=torch.int32).contiguous()
    if m >= 2**31 - 1:
        raise ValueError("M must be below 2**31 - 1 (31-bit op counts)")
    if bsz * -(-m // TILE) >= 2**31:
        raise ValueError("B * M passes the kernel's 2**31 - 1 blocks")
    scratch = torch.empty(scratch_words(bsz, m, k), dtype=torch.int32,
                          device=dev)
    keys = torch.empty((bsz, m), dtype=torch.int32, device=dev)
    pays = torch.empty((bsz, m), dtype=torch.int32, device=dev)
    totals = torch.zeros(bsz, dtype=torch.int32, device=dev)
    has_ref = torch.zeros(bsz, dtype=torch.int32, device=dev)
    P = _build.ptr
    trace.count("kernels.launches.K1")
    if seg is not None:
        trace.count("kernels.launches.K1.seg")
    if mode == "mono":
        trace.count("kernels.launches.K1.mono")
    _build.launch(
        "frontend", "k1_decode_front", dev,
        P(data), P(clen), bsz, m, int(n_max), MODES[mode], k,
        int(seg_px or 0), P(scratch), P(keys), P(pays), P(totals),
        P(has_ref))
    return keys, pays, totals, has_ref
