"""QOI-compat (``.qoi``) decode on the card: the optimistic fixpoint over
the color index table, and the sequential decode of mono streams.

Port of ``seqoia_tpu/codec/decode_compat.py``. The index table is
sequential state (reference: seqoia.h:753-755,785-787): every decoded pixel
writes table[hash(px)], and an INDEX op reads a slot whose content depends
on all earlier values. Each op's value depends only on strictly earlier ops, so
the fixpoint of "rebuild every value from the assumed INDEX values, then
resolve every INDEX read against those values" is unique and equals the
sequential decode, and each pass settles at least the earliest INDEX read
still wrong. The loop starts from the zeroed table and stops when no row's
assumptions change or after ``_MAX_ITERS`` resolutions, and flags the rows
that did not settle, as the JAX package does.

The JAX package decodes those rows on the host; the port finishes them on
the card. The zero guesses give the INDEX ops alpha 0, and the alpha every
later op carries from them moves the hashes of all later pixels, so on
opaque photo content the fixpoint settles about one INDEX read per pass
(``native.compat_probe`` measures that chain). The port restarts those rows
from guesses whose alpha is speculated (the alpha of the latest RGBA op,
255 before any) and resolves them for at most ``_SETTLE_ITERS`` more
passes: the same unique fixpoint, reached in a few passes when the
speculation holds. A row still unsettled then (a long chain of INDEX reads
of values derived from the read before) goes to K9, the sequential decoder
(the color form of ``decode_jax.decode_stream_compat``'s scan), one warp
a row, so no row costs more than a bounded number of passes and one
sequential walk.

Per pass on the card: K11 rebuilds every op's value and hash from the op
bytes and the assumed INDEX values in one look-back launch, K7 resolves the
INDEX reads, and K11's check says which rows changed
(``codec.fixpoint.fused`` counts the passes); the JAX package computes the
values as XLA ops around two segmented sums, which the CPU path keeps
(``_resolve``, ``_op_values``). Before the loop K8 (the tokenizer's map
composition) finds the op starts and K5 compacts the op bytes; the
restart's alpha is a K8 fill; after the loop K11 gives the values and K2
places the pixels and emits them in one launch, through the decode
epilogue of the row's and the output's channels (the JAX package fills them
with K6 and emits them in XLA).

Mono ``.qoi`` (a header with 1 or 2 channels and a 128-slot index, a
decoder-only quirk the encoder cannot produce) takes the JAX package's
route for it, which has no fixpoint (``fixpoint_ok`` is false for mono):
the mono tokenizer (K8), K5 compaction, K9's mono step over every row, and
K2 with the mono or gray-to-RGB(A) epilogue.
"""

from __future__ import annotations

import os

import torch

from .. import spec
from ..ops import compact, fixpoint, scan, scan_ops, sequential, slots
from ..utils import trace
from .decode_v2 import _emit, _tokenize

# resolutions before a row is flagged unconverged: INDEX-light content
# settles in <= 3, palette-heavy chains advance about one link per pass.
# SEQOIA_FIXPOINT_ITERS sets it, read at import, as in the JAX package
# (the first resolution always runs, so 0 and 1 both mean one)
_MAX_ITERS = int(os.environ.get("SEQOIA_FIXPOINT_ITERS", "12"))
# resolutions from the alpha-speculated restart before a row goes to K9
# (opaque photos settle in a few)
_SETTLE_ITERS = 16


def _resolve(ops, valid, qslot, totals, iv):
    """One fixpoint pass: the values from the assumed INDEX values ``iv``,
    then every INDEX read resolved against them. Returns (new iv, (B,)
    stable: no read changed)."""
    px, is_index = _op_values(ops, iv, valid)
    hashes = torch.where(valid, spec.color_hash(
        px & 255, (px >> 8) & 255, (px >> 16) & 255, (px >> 24) & 255),
        -1).to(torch.int32)
    got = slots.slot_last_writer(hashes, px, qslot, init=0, n_live=totals)
    new_iv = torch.where(is_index, got, 0)
    return new_iv, (new_iv == iv).all(dim=-1)


def _unsettled(stable, kind: str) -> int:
    """How many rows of a pass are not yet stable: one host read."""
    trace.host_sync(kind)
    return stable.shape[0] - int(stable.sum())


def _settle(r, iv, rows):
    """Resolve ``rows``, which the fixpoint left unsettled (``r``: their
    _Rows), restarted from ``iv`` with the alpha of every INDEX guess
    speculated (the alpha of the latest RGBA op, 255 before any), until they
    are stable or ``_SETTLE_ITERS`` passes ran. Returns (iv, passes, the rows
    of ``rows`` still unsettled)."""
    b0, b4 = r.lo & 255, r.hi & 255
    alpha = scan.fill_forward(b4, (b0 == spec.OP_RGBA) & r.valid, 255)
    iv = torch.where((b0 < spec.QOI_INDEX_SIZE) & r.valid,
                     (iv & 0xFFFFFF) | (alpha << 24), 0)
    passes = 0
    while True:
        with trace.span("codec.settle.pass", rows=len(rows)) as sp:
            iv, stable = r.resolve(iv)
            passes += 1
            last = passes == _SETTLE_ITERS
            if not last:
                unsettled = _unsettled(stable, "settle")
                sp.set(unsettled=unsettled)
        if last or not unsettled:
            break
    late = rows[~stable]
    trace.host_sync("late_rows")  # the boolean index reads its count
    sp.set(unsettled=len(late))
    return iv, passes, late


class _Rows:
    """The compacted ops of a batch of color rows (``_ops``' lo, hi and
    totals) and the fixpoint's passes over them: K11 and K7 on a card,
    ``_resolve`` and ``_op_values`` on the CPU."""

    def __init__(self, lo, hi, totals):
        self.lo, self.hi, self.totals = lo, hi, totals
        b0 = lo & 255
        self.valid = torch.arange(lo.shape[1], device=lo.device)[None, :] \
            < totals[:, None]
        self.qslot = torch.where((b0 < spec.QOI_INDEX_SIZE) & self.valid, b0,
                                 -1).to(torch.int32)
        self.ops = None if lo.is_cuda else (
            b0, (lo >> 8) & 255, (lo >> 16) & 255, (lo >> 24) & 255, hi & 255)

    def take(self, rows):
        return _Rows(self.lo[rows], self.hi[rows], self.totals[rows])

    def resolve(self, iv):
        """One fixpoint pass: (new iv, (B,) stable: no read changed). K7
        answers 0 wherever no INDEX op reads, so its answers are the new
        iv."""
        if self.ops is not None:
            return _resolve(self.ops, self.valid, self.qslot, self.totals, iv)
        trace.count("codec.fixpoint.fused")
        px, hashes = fixpoint.op_values(self.lo, self.hi, iv, self.totals)
        got = slots.slot_last_writer(hashes, px, self.qslot, init=0,
                                     n_live=self.totals)
        return got, fixpoint.settled(got, iv)

    def values(self, iv):
        """Packed RGBA after each op, given the INDEX values ``iv``."""
        if self.ops is not None:
            return _op_values(self.ops, iv, self.valid)[0]
        return fixpoint.op_values(self.lo, self.hi, iv, self.totals,
                                  hashes=False)[0]


def _op_values(ops, iv, valid):
    """Packed RGBA after each op, given the assumed INDEX values ``iv``.
    Returns (px, is_index), (B, mo) int32 and bool."""
    b0, b1, b2, b3, b4 = ops
    is_rgb = b0 == spec.OP_RGB
    is_rgba = b0 == spec.OP_RGBA
    is_index = (b0 < spec.QOI_INDEX_SIZE) & valid
    is_diff = (b0 & spec.MASK_2) == spec.QOI_OP_DIFF
    is_luma = ((b0 & spec.MASK_2) == spec.OP_LUMA) & ~is_rgb & ~is_rgba
    absolute = is_rgb | is_rgba
    vg = (b0 & 0x3F) - 32
    W = torch.where

    def channel(index_val, abs_val, diff_val, luma_val):
        out = W(is_index, index_val, W(absolute, abs_val, W(
            is_diff, diff_val, W(is_luma, luma_val, 0))))
        return W(valid, out, 0)

    r_el = channel(iv & 255, b1, ((b0 >> 4) & 3) - 2, vg - 8 + ((b1 >> 4) & 15))
    g_el = channel((iv >> 8) & 255, b2, ((b0 >> 2) & 3) - 2, vg)
    b_el = channel((iv >> 16) & 255, b3, (b0 & 3) - 2, vg - 8 + (b1 & 15))
    a_el = W(valid, W(is_index, (iv >> 24) & 255, W(is_rgba, b4, 0)), 0)
    r_reset = (absolute | is_index) & valid
    a_reset = (is_rgba | is_index) & valid

    rg = scan.segmented_modsum(
        scan_ops.pack_pair(r_el, r_reset, g_el, r_reset))
    ba = scan.segmented_modsum(
        scan_ops.pack_pair(b_el, r_reset, a_el, a_reset))
    a_v = (ba >> 16) & 255
    # alpha is 255 until the first RGBA or INDEX anchor (seqoia.h:716-719)
    a_v = W((ba >> 24) & 1 == 1, a_v, (a_v + 255) & 255)
    px = (rg & 255) | (((rg >> 16) & 255) << 8) | ((ba & 255) << 16) \
        | (a_v << 24)
    return px, is_index


def _ops(data, chunks_len, colch: int = 3):
    """Tokenize (B, M) uint8 streams and compact their ops (K8, K5).
    Returns (lo, hi, totals): op bytes 0-3 and byte 4 as (B, mo) int32,
    mo the longest row's op count (the JAX package keeps all M slots; the
    ones past every row's total change nothing), and the ops per row. Mono
    ops (colch 1) are at most 3 bytes: hi is None."""
    dev = data.device
    bsz, m = data.shape
    b = data.to(torch.int32)
    clen = chunks_len.to(device=dev, dtype=torch.int32)[:, None]
    token = _tokenize(b, clen, colch)

    def ahead(k):
        return torch.cat([b[:, k:], torch.zeros_like(b[:, :k])], dim=-1)

    lo = b | (ahead(1) << 8) | (ahead(2) << 16) | (ahead(3) << 24)
    idx = torch.arange(m, dtype=torch.int32, device=dev).expand(bsz, m)
    pays = [lo] if colch == 1 else [lo, ahead(4)]
    _, pays_c, totals = compact.compact(token, idx, pays)
    trace.host_sync("ops")
    mo = max(int(totals.max()), 1)
    hi_c = None if colch == 1 else pays_c[1][:, :mo]
    return pays_c[0][:, :mo], hi_c, totals


def _expand(b0, px, valid, n_pixels, colch, out_ch, n_max):
    """Place each op's value over its pixels and emit out_ch bytes per pixel
    (K2): flat uint8 (B, n_max * out_ch)."""
    npix = torch.where(b0 >= spec.OP_RUN, (b0 & 0x3F) + 1, 1)
    npix = torch.where((b0 == spec.OP_RGB) | (b0 == spec.OP_RGBA), 1, npix)
    npix = torch.where(valid, npix, 0)
    pixoff = scan_ops.blocked_cumsum(npix) - npix
    n_ops = (valid & (pixoff < n_max)).sum(dim=-1).to(torch.int32)
    npx = n_pixels.to(device=px.device, dtype=torch.int32)[:, None]
    return _emit(pixoff, px, n_ops, npx, n_max, colch, out_ch,
                 every_row=True).view(torch.uint8)


def decode_stream_compat_batched(data, chunks_len, n_pixels, *, colch: int,
                                 out_ch: int, n_max: int, stats=None):
    """Decode a batch of QOI-compat streams, color (colch 3) or mono
    (colch 1).

    data: (B, M) uint8; chunks_len (stream length less the end marker) and
    n_pixels: (B,); n_max: pixel slots per row (>= n_pixels, a multiple of
    4). Returns (pixels (B, n_max * out_ch) flat uint8, converged (B,)
    bool). Every row's pixels are exact; ``converged`` says which rows the
    fixpoint settled within ``_MAX_ITERS`` passes (the JAX package's flags,
    which send the other rows to its host decoder), and the port finishes
    the others on the card; mono rows run no fixpoint (K9 decodes them
    all) and are all flagged settled. A ``stats`` dict receives the
    fixpoint's resolutions ("passes"), the rows restarted after it
    ("settled_rows"), the resolutions the restart ran ("settle_passes") and
    the rows K9 decoded ("sequential_rows")."""
    if colch not in (1, 3):
        raise ValueError("colch must be 1 or 3")
    if out_ch not in (1, 2, 3, 4):
        raise ValueError("out_ch must be 1 to 4")
    dev = data.device
    bsz = data.shape[0]
    lo_c, hi_c, totals = _ops(data, chunks_len, colch)
    if colch == 1:
        with trace.span("codec.sequential", rows=bsz):
            px = sequential.sequential_decode(lo_c, None, totals, colch=1)
        if stats is not None:
            stats.update(passes=0, settled_rows=0, settle_passes=0,
                         sequential_rows=bsz)
        valid = torch.arange(lo_c.shape[1], device=dev)[None, :] \
            < totals[:, None]
        return (_expand(lo_c & 255, px, valid, n_pixels, 1, out_ch, n_max),
                torch.ones(bsz, dtype=torch.bool, device=dev))
    r = _Rows(lo_c, hi_c, totals)

    # one resolution, then more until every row is stable or _MAX_ITERS
    # resolutions ran (the JAX package's body + while_loop)
    iv = torch.zeros_like(lo_c)
    passes = 0
    while True:
        with trace.span("codec.fixpoint.pass", rows=bsz) as sp:
            iv, stable = r.resolve(iv)
            passes += 1
            last = passes >= _MAX_ITERS
            if not last:
                unsettled = _unsettled(stable, "fixpoint")
                sp.set(unsettled=unsettled)
        if last or not unsettled:
            break
    rows = (~stable).nonzero()[:, 0]
    trace.host_sync("unsettled_rows")  # nonzero reads its count
    sp.set(unsettled=len(rows))
    more, late = 0, rows[:0]
    if len(rows):
        iv[rows], more, late = _settle(r.take(rows), iv[rows], rows)
    px = r.values(iv)
    if len(late):
        with trace.span("codec.sequential", rows=len(late)):
            px[late] = sequential.sequential_decode(lo_c[late], hi_c[late],
                                                    totals[late])
    if stats is not None:
        stats.update(passes=passes, settled_rows=len(rows),
                     settle_passes=more, sequential_rows=len(late))
    return (_expand(lo_c & 255, px, r.valid, n_pixels, colch, out_ch, n_max),
            stable)
