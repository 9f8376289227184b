"""Deterministic synthetic benchmark corpus.

The qoi-bench image suite is not redistributable here, so the bench uses a
synthetic corpus whose composition mirrors the suite's categories
(SURVEY.md §2.4/§6) *and* its codec-relevant content statistics. Each
generator was tuned against the reference encoder (native oracle) until its
per-category compression profile matches the published bench10.txt tables in
both sign and rough magnitude of the sqoa-vs-qoi size delta:

* icons (icon_64/icon_512): transparent background, vertical-gradient disk
  fills (flat rows -> runs), 1.5px rim antialiasing, and colored translucent
  glow rings whose per-pixel alpha steps stay inside SQOA's 1-byte ALPHA
  modifier range (seqoia.h:119-121) while per-pixel fuzz defeats QOI's
  exact-color INDEX recurrence -- the same reason real icon suites favor
  sqoa (bench10.txt: icon_512 7.7% vs 8.4%, icon_64 26.5% vs 28.7%);
* pngimg: the same alpha mechanisms over photo-grained object interiors
  (matted photos), reproducing the suite's -2.2% sqoa win (bench10.txt:52-53);
* photo: smooth gradients + grain strong enough that QOI's DIFF window
  [-2,1] almost never fires, plus posterized sky-like plateau bands (runs
  for both codecs) -- the real photo suites are size-equal between the two
  formats (bench10.txt:70-71, photo_kodak 671 KB both);
* screenshot: large flat margins (BIGRUN wins, 512 vs 62 max run), content
  blocks with embedded photo-like regions and text speckle;
* texture: periodic pattern + grain + full-width flat atlas padding bands;
* mono_doc: grayscale scans exercising the 1/2-channel mono kernels (no
  qoi comparison -- mono+compat is rejected, seqoia.h:477-480).

``mono_qoi`` is no image: it writes mono ``.qoi`` streams op by op, which
no encoder produces but the decoder reads (seqoia.h:690-693).
"""

from __future__ import annotations

import functools
import struct

import numpy as np


def _icon(rng, size, n_shapes, glow_w=0.2, glow_peak=0.45, fuzz=1.5,
          grad=0.25):
    """Glossy-icon imagery (see module docstring)."""
    img = np.zeros((size, size, 4), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(n_shapes):
        cx, cy = rng.integers(size // 8, size - size // 8, 2)
        r = int(rng.integers(size // 6, size // 3))
        col = rng.integers(60, 256, 3).astype(np.float32)
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        # colored glow ring: alpha ramps 0..peak over glow_w*r px; the
        # per-pixel step stays within SQOA's ALPHA modifier (+-16) and the
        # fuzz keeps QOI from INDEX-hitting exact recurrences
        gw = max(2.0, glow_w * r)
        ga = np.clip((r * (1 + glow_w) - d) / gw, 0, 1) * glow_peak
        gm = (ga > 0) & (d > r)
        if fuzz > 0:
            ga = np.where(
                gm,
                np.clip(ga + rng.normal(0, fuzz / 255, (size, size)), 0, 1),
                ga,
            )
        repl = gm & (ga * 255 > img[..., 3])
        for c in range(3):
            img[..., c] = np.where(repl, col[c] * 0.6, img[..., c])
        img[..., 3] = np.where(repl, ga * 255, img[..., 3])
        # disk: vertical-gradient fill (rows flat -> runs), 1.5px AA rim
        a = np.clip((r - d) / 1.5, 0, 1)
        g = 1 - grad * (yy - (cy - r)) / max(1, 2 * r)
        for c in range(3):
            img[..., c] = np.where(a > 0, col[c] * np.clip(g, 0, 1),
                                   img[..., c])
        img[..., 3] = np.where(a > 0, np.maximum(img[..., 3], a * 255),
                               img[..., 3])
    return np.clip(img, 0, 255).astype(np.uint8)


def _pngimg(rng, size, n_shapes):
    """Photo objects matted onto transparency: icon alpha mechanisms over
    photo-grained interiors."""
    img = _icon(rng, size, n_shapes, glow_w=0.25, glow_peak=0.4).astype(
        np.float32
    )
    mask = img[..., 3] > 200
    grain = rng.normal(0, 5, (size, size, 1)) + rng.normal(
        0, 2.0, (size, size, 3)
    )
    img[..., :3] = np.where(mask[..., None], img[..., :3] + grain,
                            img[..., :3])
    return np.clip(img, 0, 255).astype(np.uint8)


def _photo(rng, w, h, luma_sd=8.0, chroma_sd=2.5, plateau=0.35):
    """Photo-like content: smooth gradients + grain strong enough that
    QOI's DIFF window rarely fires, with posterized smooth plateau bands
    (sky/bokeh) that run-length-encode identically in both codecs."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [
            120 + 80 * np.sin(xx / (40 + rng.integers(1, 40))),
            120 + 80 * np.cos(yy / (30 + rng.integers(1, 40))),
            120 + 80 * np.sin((xx + yy) / (50 + rng.integers(1, 40))),
        ],
        axis=-1,
    )
    img = base + rng.normal(0, luma_sd, (h, w, 1)) + rng.normal(
        0, chroma_sd, (h, w, 3)
    )
    if plateau > 0:
        m = np.sin(xx / 97.0 + 2.1) + np.cos(yy / 71.0) > (1 - 2 * plateau)
        img = np.where(m[..., None], np.round(base / 16) * 16, img)
    return np.clip(img, 0, 255).astype(np.uint8)


def _screenshot(rng, w, h):
    """UI content: large flat margins (BIGRUN wins), content blocks with
    text speckle, photo-like image regions, and flat panels."""
    img = np.zeros((h, w, 3), np.float32)
    img[:] = rng.integers(235, 256, 3)
    x0, x1 = w // 5, w - w // 5
    y = h // 12
    while y < h - h // 12:
        bh = int(rng.integers(h // 12, h // 5))
        kind = rng.random()
        if kind < 0.45:  # text block: sparse speckle rows
            for ty in range(y, min(y + bh, h), 3):
                mask = np.zeros(w, bool)
                mask[x0:x1] = rng.random(x1 - x0) < 0.05
                img[ty, mask] -= rng.integers(8, 28, (int(mask.sum()), 1))
        elif kind < 0.75:  # image block: photo-like region
            yy2, xx2 = np.mgrid[0 : min(bh, h - y), 0 : x1 - x0]
            base = np.stack(
                [
                    140 + 60 * np.sin(xx2 / 23.0),
                    140 + 60 * np.cos(yy2 / 17.0),
                    140 + 60 * np.sin((xx2 + yy2) / 31.0),
                ],
                axis=-1,
            )
            grain = rng.normal(0, 8, base.shape[:2] + (1,)) + rng.normal(
                0, 2.5, base.shape
            )
            img[y : y + bh, x0:x1] = base + grain
        else:  # flat panel with a border
            shade = rng.integers(190, 250, 3)
            img[y : y + bh, x0:x1] = shade
            img[y, x0:x1] = shade - 40
        y += bh + int(rng.integers(h // 24, h // 10))
    return np.clip(img, 0, 255).astype(np.uint8)


def _texture(rng, w, h):
    """Game-texture-like: periodic pattern + grain, plus full-width flat
    padding bands (atlas dead space -> long runs)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 96 + 48 * np.sin(xx / 9.1) * np.cos(yy / 7.3)
    grain = rng.normal(0, 11, (h, w, 1)) + rng.normal(0, 2.5, (h, w, 3))
    img = base[..., None] + grain
    for _ in range(5):  # full-width dead bands
        py = int(rng.integers(0, h - h // 8))
        img[py : py + h // 10] = float(rng.integers(40, 200))
    return np.clip(img, 0, 255).astype(np.uint8)


def _mono_doc(rng, w, h):
    """Grayscale document-scan-like content (mono mode, channels=1):
    flat background + text speckle + a gradient figure."""
    img = np.full((h, w, 1), 245, np.float32)
    for ty in range(h // 10, h - h // 10, 3):
        mask = np.zeros(w, bool)
        mask[w // 8 : w - w // 8] = rng.random(w - 2 * (w // 8)) < 0.18
        img[ty, mask, 0] -= rng.integers(60, 200, int(mask.sum()))
    yy2, xx2 = np.mgrid[0 : h // 4, 0 : w // 3]
    img[h // 2 : h // 2 + h // 4, w // 3 : 2 * (w // 3), 0] = (
        170 + 50 * np.sin(xx2 / 19.0) + rng.normal(0, 4, (h // 4, w // 3))
    )
    return np.clip(img, 0, 255).astype(np.uint8)


def make_corpus(scale: float = 1.0, seed: int = 0, labels: bool = False):
    """Returns list of (pixels_flat_u8, width, height, channels) tuples,
    or (pixels, w, h, ch, category) with ``labels=True``. Categories mirror
    the qoi-bench suite's composition (SURVEY.md §2.4/§6)."""
    rng = np.random.default_rng(seed)
    images = []

    def add(img, cat):
        h, w = img.shape[:2]
        images.append((img.reshape(-1).copy(), w, h, img.shape[2], cat))

    for _ in range(max(1, int(8 * scale))):
        add(_icon(rng, 64, 5, glow_w=0.6, glow_peak=0.5), "icon_64")
    for _ in range(max(1, int(4 * scale))):
        add(_icon(rng, 512, 4, glow_w=0.15, glow_peak=0.52), "icon_512")
    for _ in range(max(1, int(2 * scale))):
        add(_pngimg(rng, 1024, 6), "pngimg")
    for _ in range(max(1, int(4 * scale))):
        add(_screenshot(rng, 1024, 768), "screenshot")
    for _ in range(max(1, int(6 * scale))):
        add(_photo(rng, 768, 512), "photo")
    # multi-Mpx photos (the reference suite's photo_tecnick/wikipedia class)
    for _ in range(max(1, int(scale / 4))):
        add(_photo(rng, 2048, 1536), "photo_large")
    for _ in range(max(1, int(2 * scale))):
        add(_texture(rng, 512, 512), "texture")
    # RGB photos carrying a mostly-opaque alpha plane
    for _ in range(max(1, int(2 * scale))):
        img = _photo(rng, 512, 384)
        a = np.full(img.shape[:2] + (1,), 255, np.int16)
        # sparse small alpha dips (watermark-like) within SQOA's +-16
        # ALPHA-modifier range (seqoia.h:119-121)
        dips = rng.random(img.shape[:2]) < 0.01
        a[dips] -= rng.integers(8, 16, (int(dips.sum()), 1))
        add(np.concatenate([img, a.astype(np.uint8)], axis=-1), "photo_rgba")
    # grayscale scans: the 1/2-channel mono kernels (no qoi comparison)
    for _ in range(max(1, int(2 * scale))):
        add(_mono_doc(rng, 640, 480), "mono_doc")
    if labels:
        return images
    return [t[:4] for t in images]


#: mono .qoi op kinds of ``mono_qoi``: INDEX, LUMA, RUN, RGB, RGBA
MONO_QOI_OPS = ("index", "luma", "run", "rgb", "rgba")


def mono_qoi(rng, w, h, channels=1, weights=(0.5, 0.2, 0.15, 0.1, 0.05)):
    """A mono ``.qoi`` stream (a ``qoif`` header with 1 or 2 channels) of
    seeded random ops that decode to exactly w * h pixels, ending in the
    8-byte marker. Ops are drawn with ``weights`` over MONO_QOI_OPS:
    INDEX (a tag below 128: a slot of the 128-entry index), LUMA (gray
    delta -32..31), RUN (1-62 pixels), RGB (0xFE gray) and RGBA (0xFF gray
    alpha). The default leans on INDEX, so most ops read the table."""
    n = w * h
    est = n // 4 + 64
    while True:
        kind = rng.choice(len(MONO_QOI_OPS), size=est, p=weights)
        run = rng.integers(1, 63, est)
        cs = np.cumsum(np.where(kind == 2, run, 1))
        if cs[-1] >= n:
            break
        est *= 2
    cut = int(np.searchsorted(cs, n)) + 1
    kind, run = kind[:cut], run[:cut]
    run[-1] -= cs[cut - 1] - n  # the last op ends on the last pixel
    tag = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [rng.integers(0, 128, cut), 0x80 + rng.integers(0, 64, cut),
         0xC0 + run - 1, np.full(cut, 0xFE)], 0xFF)
    if tag[0] == 0x31:  # the start byte would make the header SQOA's
        tag[0] = 0x30
    lens = np.where(kind == 3, 2, np.where(kind == 4, 3, 1))
    off = np.cumsum(lens) - lens
    body = np.zeros(int(lens.sum()), np.uint8)
    body[off] = tag
    wide = off[kind >= 3]
    body[wide + 1] = rng.integers(0, 256, wide.size)
    body[off[kind == 4] + 2] = rng.integers(0, 256, int((kind == 4).sum()))
    return (b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + body.tobytes()
            + bytes((0, 0, 0, 0, 0, 0, 0, 1)))


#: ``ref_sqoa``'s search: op boundaries spread over the stream, and the ops
#: walked from each
REF_SITES, REF_WALK = 64, 256


def _op_len(data, p, colch):
    """Bytes of the op at p of a SQOA stream without REF: the tag, its
    operands and (color) a trailing alpha modifier."""
    tag = data[p]
    if tag < 0x60:
        return None  # a REF or a stray modifier: not an encoder's op
    if tag == 0xFE or tag == 0xFF:
        n = 1 + colch + (tag == 0xFF)
    elif tag < 0xC0 and colch == 3:
        n = 2  # LUMA and its operand
    else:
        n = 1  # mono LUMA, RUN, BIGRUN
    if colch == 3 and p + n < len(data) and 0x60 <= data[p + n] < 0x80:
        n += 1
    return n


def _ref_sites(data, colch, starts, rng, keep_pixels):
    """The splices of ``ref_sqoa``: [(position, bytes replaced, REF tag)],
    one at most from each start, REF_WALK ops on; with ``keep_pixels``
    only those after which the stream decodes to the same pixels."""
    end = len(data) - 8
    splices, floor = [], 0  # windows stay at or past floor
    for p0 in starts:
        if p0 < floor:
            continue
        ops, p = [], p0  # (position, length) of the ops from p0
        while p < end and len(ops) < REF_WALK:
            n = _op_len(data, p, colch)
            if n is None:
                break
            ops.append((p, n))
            p += n
        found = []
        for k in range(len(ops) - 2):
            q = ops[k][0]
            for m in (1, 2, 3):  # the replaced bytes: m whole ops
                if k + m + 1 >= len(ops):
                    break
                L = ops[k + m][0] - q
                if L > 4:
                    break
                c0, c1 = ops[k + m], ops[k + m + 1]
                if L < 2 or keep_pixels and not (
                        c0[1] == c1[1] == 1 and data[c0[0]] == data[c1[0]]):
                    continue
                want = data[q: q + L]
                for off in range(1, 32):  # window [e - L, e), e = q + 1 - off
                    e = q + 1 - off
                    if e - L < max(floor, 15):
                        break
                    if data[e - L: e] == want and (
                            colch == 1 or e == q
                            or not 0x60 <= data[e] < 0x80):
                        found.append((q, L, ((L - 2) << 5) | off))
                        break
        if found:
            q, L, tag = found[int(rng.integers(len(found)))]
            splices.append((q, L, tag))
            floor = q + L + 2  # past the skipped and the twice-read byte
    return splices


def ref_sqoa(stream: bytes, rng):
    """A SQOA stream with REF ops spliced into ``stream`` (a stream without
    REF, as every encoder writes), or None where no site was found or
    ``native.decode`` refuses the result. No encoder writes REF.

    REF (a tag below 0x60) replays 2 + (tag >> 5) bytes from a window that
    ends (tag & 31) bytes before the cursor, then teleports the cursor to
    one past the byte after the REF and reads there without advancing
    (seqoia.h:418, 729-738): the byte after the REF is skipped and the next
    one read twice. A splice replaces 2-4 bytes of whole ops that repeat a
    window ending at most 31 bytes back by one REF byte. Where the two ops
    after them are the same one-byte op (a RUN, a BIGRUN or a mono LUMA),
    the stream still decodes to the same pixels; the maker takes only such
    sites where the stream has any. Elsewhere the decoder goes on from the
    wrong byte, and ``native.decode``'s pixels are the truth. Sites are
    searched from REF_SITES op boundaries spread over the stream
    (``native.scan_chunks``), REF_WALK ops from each; one is spliced a
    boundary, chosen with ``rng``."""
    from .. import native

    hdr = native.peek_header(stream)
    if hdr is None or hdr[4]:
        raise ValueError("ref_sqoa takes a SQOA (non-compat) stream")
    colch = 1 if hdr[2] < 3 else 3
    bounds = native.scan_chunks(stream, REF_SITES)
    if bounds is None:
        raise ValueError("ref_sqoa takes a stream without REF ops")
    starts = sorted(set(int(b) for b in bounds[:, 0]))
    splices = (_ref_sites(stream, colch, starts, rng, True)
               or _ref_sites(stream, colch, starts, rng, False))
    if not splices:
        return None
    parts, p = [], 0
    for q, L, tag in splices:
        parts += [stream[p: q], bytes((tag,))]
        p = q + L
    made = b"".join(parts + [stream[p:]])
    return made if native.decode(made, 0)[0] is not None else None


def ref_hand_made():
    """{case: stream}: small SQOA streams with REF ops, one for each turn of
    the REF cursor (the JAX package's hand-made streams)."""
    from .. import spec

    def sqoa(w, ch, ops):
        return (spec.pack_header(spec.SqoaDesc(w, 1, ch, 0, 0)) + bytes(ops)
                + spec.PADDING)
    return {
        # RGB(1,2,3), LUMA pair, REF len=2 off=1 (replays the LUMA pair)
        "replay": sqoa(4, 3, [0xFE, 1, 2, 3, 0xA3, 0x76, 1]),
        # REF len=4 off=1: the replay ends mid-operand, the cursor
        # teleports while reading an operand (SQOA_NEXT, seqoia.h:418)
        "mid_operand": sqoa(4, 3, [0xFE, 1, 2, 3, 0xA3, 0x76, 0x41]),
        # a window that starts before the stream: err (seqoia.h:733-736)
        "negative_start": sqoa(4, 3, [0xFE, 1, 2, 3, 31]),
        # REF len=4 replaying two LUMA pairs, then the window is spent
        # with pixels left: the cursor teleports to resume + 1
        "window_spent": sqoa(7, 3, [0xFE, 1, 2, 3, 0xA1, 0x11, 0xA2, 0x22,
                                    0x41, 0xFE, 7, 7, 7]),
        # mono: a REF replaying a gray LUMA byte
        "mono": sqoa(5, 1, [0xFE, 9, 0x85, 0x9F, 1]),
    }


def ref_injected(n: int = 40, seed: int = 7):
    """n seeded 5x3 encodes (noise, flat, ramp; channels 3, 4, 1, 2 in
    turn) with 1-3 REF-range bytes written over op bytes: mostly malformed
    streams, as a fuzzer makes them."""
    from .. import native

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ch = (3, 4, 1, 2)[i % 4]
        stride = (1 if ch < 3 else 3) + (1 - (ch & 1))
        kind = i % 3
        if kind == 0:
            px = rng.integers(0, 256, 15 * stride)
        elif kind == 1:
            px = np.repeat(rng.integers(0, 256, (1, stride)), 15, 0)
        else:
            px = (np.arange(15 * stride) * int(rng.integers(1, 9))) % 256
        s = bytearray(native.encode(np.asarray(px, np.uint8).reshape(-1), 5,
                                    3, ch, 0, 0))
        for _ in range(int(rng.integers(1, 4))):
            s[int(rng.integers(15, max(16, len(s) - 8)))] = int(
                rng.integers(0, 0x60))
        out.append(bytes(s))
    return out


class _EdgeBody:
    """The op bytes of a hand-built SQOA stream (they follow the header and
    the start byte, so the first lies at stream position 15) and the pixels
    its in-line ops emit."""

    def __init__(self, rng, colch):
        self.rng, self.colch = rng, colch
        self.body, self.px = bytearray(), 0

    def at(self):
        return 15 + len(self.body)

    def add(self, ops, px=0):
        self.body += bytes(ops)
        self.px += px

    def run(self, r):  # a RUN of r + 1 pixels (r in 0-60)
        self.add([0xC0 | r], r + 1)

    def op(self):
        """One random op of the encoder's kinds, (color) an alpha modifier
        after one in five; short runs, so that the pixels stay few."""
        rng, c = self.rng, self.colch
        k = int(rng.integers(4))
        if k == 0:
            ops = [0xFE] + rng.integers(0, 256, c).tolist()
        elif k == 1:
            ops = [0xFF] + rng.integers(0, 256, c + 1).tolist()
        elif k == 2:
            ops = [0x80 | int(rng.integers(64))] + (
                [int(rng.integers(256))] if c == 3 else [])
        else:
            return self.run(int(rng.integers(8)))
        if c == 3 and rng.random() < 0.2:
            ops.append(0x60 | int(rng.integers(32)))
        self.add(ops, 1)

    def fill_to(self, p):
        """Whole ops up to stream position p, ending in one-byte RUNs."""
        while p - self.at() > 8:
            self.op()
        while self.at() < p:
            self.run(int(self.rng.integers(8)))

    def pair(self, n):
        """n bytes (2-4) of whole ops, ending in one that takes no
        modifier."""
        if self.colch == 3:
            lum = [0x80 | int(self.rng.integers(64)), 0xC5]
            ops = {2: lum, 3: lum + [0xC1], 4: [0xFE, 1, 2, 3]}[n]
        else:
            ops = {2: [0xFE, 77], 3: [0xFF, 78, 200], 4: [0xFE, 79, 0x85,
                                                         0xC2]}[n]
        self.add(ops, 1 if n < 3 or self.colch == 3 and n == 4 else 2)


def ref_edge_streams(chunk: int, seed: int = 11):
    """{name: stream}: SQOA streams (channels 4, colch 3, and channels 2,
    colch 1) whose REF ops sit on the edge between the chunks 1 and 2 of
    K10's staging (``chunk`` bytes a chunk; ops/ref.py's CHUNK on the card):

    - ``straddle``: a replay window across the edge;
    - ``resume_at_edge``, ``resume_past_edge``: a REF just before the edge,
      whose teleport lands on it and one past it;
    - ``far_teleport``: a REF 3 bytes before the edge replaying a window 31
      bytes back, so the teleport from the window's end crosses the edge;
    - ``peek_at_end`` (color): the window ends where the replayed op's alpha
      modifier lay, so the raw peek sees a modifier and next() consumes the
      byte after the resume point; at the edge and away from it;
    - ``nested``: a REF inside another's window (the cursor then loops
      until the pixels are done);
    - ``ladder``: REF windows that each hold the REF before, so that the
      cursor walks back chunk after chunk;
    - ``run_end``, ``bigrun_end``: the last pixel inside a RUN or BIGRUN
      that starts at the edge;
    - ``dense_0``-``dense_3``: random REF tags spliced at op boundaries.

    Every stream decodes without err (native.decode accepts it). The pixel
    count is a power of two past the ops before the sites, but for the
    run cases, whose count ends inside the run."""
    from .. import native, spec

    rng = np.random.default_rng(seed)
    edge = 2 * chunk
    out = {}

    def stream(body, ch, n):
        return (spec.pack_header(spec.SqoaDesc(n, 1, ch, 0, 0))
                + bytes(body.body) + spec.PADDING)

    def pow2_past(px):
        return 1 << (px + 1000).bit_length()

    for colch, ch in ((3, 4), (1, 2)):
        cases = {}

        def site(L, gap, q=None, peek=False, e=None):
            """W (L bytes of whole ops), the gap (its first byte a modifier
            with peek), a REF replaying W, then two equal RUNs; the REF at
            q, or W ending at e."""
            b = _EdgeBody(rng, colch)
            if q is not None:
                e = q - gap
            b.fill_to(e - L)
            b.pair(L)
            if peek:
                b.add([0x60 | int(rng.integers(32))])
            while b.at() < e + gap:
                b.run(int(rng.integers(8)))
            b.add([((L - 2) << 5) | (gap + 1)])
            px = b.px
            b.add([0xC3, 0xC3])
            for _ in range(40):
                b.op()
            return b, px

        cases["straddle"] = site(3, 5, e=edge + 1)
        # a window 31 bytes back from a REF just before the edge: from the
        # window's end the teleport lands across the edge, 33 bytes on
        cases["far_teleport"] = site(2, 30, q=edge - 3)
        cases["resume_at_edge"] = site(2, 9, q=edge - 2)
        cases["resume_past_edge"] = site(4, 20, q=edge - 1)
        if colch == 3:
            cases["peek_at_end"] = site(2, 6, e=edge, peek=True)
            cases["peek_at_end_mid"] = site(3, 3, e=edge - 700 % chunk,
                                            peek=True)
        # nested: [W2 R2 X X] gap R1, R1's window [W2 R2 X)
        b = _EdgeBody(rng, colch)
        b.fill_to(edge - 2)
        s = b.at()
        b.pair(2)
        b.add([0x01, 0xC4, 0xC4])  # R2: window [s, s + 2), off 1
        px = b.px
        for _ in range(3):
            b.run(2)
        b.add([(2 << 5) | (b.at() - (s + 4) + 1)])  # R1: [s, s + 4)
        for _ in range(20):
            b.op()
        cases["nested"] = (b, px)
        # ladder: rungs R_1..R_k are operand bytes of literal ops (an op
        # [0xFE or 0xFF, run byte, ..., R_i, ...]), so a walk in line skips
        # them; R_1 replays W0, R_i+1 replays [R_i - 1, R_i + 1): its run
        # byte, then R_i read as a tag. A real REF at the top replays the
        # last rung, and the cursor walks back rung by rung to W0.
        b = _EdgeBody(rng, colch)
        b.fill_to(max(60, edge - 3 * chunk))
        b.pair(2)
        rungs = [b.at() - 2]  # W0's start, where R_1's window begins
        while True:
            top = b.at() > edge + 2 * 26
            if not top:
                lit = [0xFE, 0xC1, 0, 0x9A] if colch == 3 else [0xFF, 0xC1, 0]
                at = b.at() + 2
            else:
                lit, at = [0], b.at()
            off = at + 1 - (rungs[-1] + 2)  # window [rungs[-1], + 2)
            lit[at - b.at()] = off  # L 2
            b.add(lit, 1)
            rungs.append(at - 1)  # the next window starts at the run byte
            if top:
                break
            for _ in range(int(rng.integers(3, 22 if colch == 3 else 24))):
                b.run(int(rng.integers(4)))
        px = b.px
        b.add([0xC2, 0xC2])
        for _ in range(20):
            b.op()
        cases["ladder"] = (b, px)
        for name, last, cut in (("run_end", 0xC0 | 60, 30),
                                ("bigrun_end", 0xFD, 300)):
            b = _EdgeBody(rng, colch)
            for _ in range(4):
                b.add([0xFD], 512)
            b.fill_to(edge)
            n = b.px + cut
            b.add([last])
            out[f"{name}_{colch}"] = stream(b, ch, n)
        for i in range(4):
            b = _EdgeBody(rng, colch)
            while b.at() < edge + 4 * 64:
                if b.at() > 60 and rng.random() < 0.08:
                    L = int(rng.integers(2, 5))
                    b.add([((L - 2) << 5) | int(rng.integers(1, 32))])
                else:
                    b.op()
            cases[f"dense_{i}"] = (b, b.px)
        for name, (b, px) in cases.items():
            out[f"{name}_{colch}"] = stream(b, ch, pow2_past(px))
    for name, s in out.items():
        if native.decode(s, 0)[0] is None:
            raise AssertionError(f"edge stream {name} does not decode")
    return out


#: the last ops of ``stream_end_stream``: name -> (color bytes, mono bytes,
#: pixels). The cut ones stop short of their operands, which the decoder
#: then reads from the end marker, and the byte it peeks for an alpha
#: modifier after them too (color: marker byte 3 after ``cut_rgba``, 1
#: after ``cut_luma``)
END_OPS = {
    "rgb": ([0xFE, 9, 200, 77], [0xFE, 9], 1),
    "rgba": ([0xFF, 9, 200, 77, 140], [0xFF, 9, 140], 1),
    "luma": ([0x9B, 0x4C], [0x9B], 1),
    "run": ([0xC3], [0xC3], 4),
    "bigrun": ([0xFD], [0xFD], 512),
    "cut_rgba": ([0xFF, 9], [0xFF], 1),
    "cut_luma": ([0x9B], [0xFE], 1),
}


def _smooth(rng, n, ch):
    """n pixels of ch channels in small steps, every other pixel repeated:
    the encoder writes LUMA, RUN and (alpha sources) alpha-modifier ops."""
    base = rng.integers(0, 256, ch)
    d = rng.integers(-3, 4, (n, ch)) * (rng.random((n, 1)) < 0.5)
    return ((base + np.cumsum(d, 0)) % 256).astype(np.uint8).reshape(-1)


def end_marker(pos):
    """The 8-byte end marker with an alpha-range byte at ``pos`` (0-7; None:
    the marker as encoders write it)."""
    from .. import spec

    marker = bytearray(spec.PADDING)
    if pos is not None:
        marker[pos] = 0x60 | (7 * pos + 10) % 32
    return bytes(marker)


def stream_end_stream(channels: int, last: str, pos, ref: bool = False,
                      icon: bool = True, seed: int = 13) -> bytes:
    """A SQOA stream of header ``channels`` (1-4) that ends in the op
    ``END_OPS[last]`` and the marker ``end_marker(pos)``. The reference
    peeks for an alpha modifier after every op of a color stream
    (seqoia.h:777-783), the last one too, so an alpha-range byte where that
    peek lands changes the last pixels' alpha; elsewhere in the marker
    only a cut op's operands are read. The ops before the last come from a native encode of
    ``_smooth`` pixels, with a REF op spliced in (``ref_sqoa``, the first
    body of the seed's that has a site) where ``ref``; the image is 16
    pixels wide (64 with a BIGRUN) and 16 high, one column wider where not
    ``icon``: ``BatchDecoder`` packs the icon ones (a pixel count that is a
    power of two) and decodes the others as rows of a class of their own
    (the next power of two). The streams of one (channels, last, ref,
    icon) differ only in their marker."""
    from .. import spec

    color, mono, _ = END_OPS[last]
    w = (64 if last == "bigrun" else 16) + (not icon)
    body = _end_body(channels, last, ref, w, seed)
    op = color if channels >= 3 else mono
    return (spec.pack_header(spec.SqoaDesc(w, 16, channels, 0, 0))
            + body[spec.HEADER_SIZE + 1: -spec.PADDING_SIZE] + bytes(op)
            + end_marker(pos))


@functools.lru_cache(maxsize=None)
def _end_body(channels, last, ref, w, seed):
    """The native stream of the ops before ``stream_end_stream``'s last."""
    from .. import native

    rng = np.random.default_rng(
        [seed, channels, list(END_OPS).index(last), ref, w])
    n0 = 16 * w - END_OPS[last][2]
    for _ in range(64):  # a body with a REF site, where one is asked for
        pix = _smooth(rng, n0, channels).reshape(n0, channels)
        # the body's last pixel changes: the encoder writes a run that
        # reaches the image's end as a BIGRUN, which would swallow the op
        pix[-1, 0] = (int(pix[-2, 0]) + 1) % 256
        body = native.encode(pix.reshape(-1), n0, 1, channels, 0, 0)
        if not ref:
            return body
        body = ref_sqoa(body, rng)
        if body is not None:
            return body
    raise AssertionError("no REF site in 64 bodies")


def malformed_streams(n: int, seed: int = 17):
    """n seeded malformed SQOA streams, a fuzzer's mix: native encodes of
    1-4-channel images of up to 32x32 pixels (smooth, noise or runs; two in
    five of them 8x8, 16x16 or 32x32, which ``BatchDecoder`` packs), each
    with one of: 1-4 bytes of its body overwritten; its body cut short at
    a random byte, the marker after it; 1-2 bytes of its marker
    overwritten, the first one time in two. A written byte is alpha-range
    one time in two."""
    from .. import native, spec

    rng = np.random.default_rng(seed)

    def byte():
        return int(rng.integers(0x60, 0x80) if rng.random() < 0.5
                   else rng.integers(256))

    out = []
    for i in range(n):
        ch = 1 + i % 4
        if rng.random() < 0.4:
            w = h = int(rng.choice([8, 16, 32]))
        else:
            w, h = (int(v) for v in rng.integers(1, 33, 2))
        kind = int(rng.integers(3))
        if kind == 0:
            px = _smooth(rng, w * h, ch)
        elif kind == 1:
            px = rng.integers(0, 256, w * h * ch).astype(np.uint8)
        else:
            px = np.repeat(rng.integers(0, 256, (w * h // 37 + 1, ch)), 37,
                           0)[: w * h].astype(np.uint8).reshape(-1)
        s = bytearray(native.encode(px, w, h, ch, 0, 0))
        start, end = spec.HEADER_SIZE + 1, len(s) - spec.PADDING_SIZE
        how = int(rng.integers(3))
        if how == 0:
            for _ in range(int(rng.integers(1, 5))):
                s[int(rng.integers(start, end))] = byte()
        elif how == 1:
            s = s[: int(rng.integers(start, end + 1))] + s[end:]
        else:  # the first marker byte (where most peeks land) one in two
            for _ in range(int(rng.integers(1, 3))):
                k = 0 if rng.random() < 0.5 else int(rng.integers(8))
                s[end + k] = byte()
        out.append(bytes(s))
    return out


def end_peek_rows(tile: int = 4096):
    """K1's edge cases for the alpha peek after a stream's last op (mode
    noalpha, RGB sources): rows of one-byte runs whose last op ends, or is
    cut, at an edge of K1's ``tile``-byte tiles or of a thread's 16 bytes,
    with an alpha-range byte where the reference peeks after it, one byte
    further on, or past the row's end. Returns ((rows, 2 * tile + 64)
    uint8, chunks_len (rows,) int32, [1 where the peek reads it])."""
    m = 2 * tile + 64
    rows = [  # (the last op's position, its bytes, chunks_len, flagged)
        (tile - 1, [0xC1], tile, 1),  # the peek: the next tile's first byte
        (tile - 2, [0xFE, 1, 2, 3], tile - 1, 1),  # cut across the edge
        (tile - 1, [0xFE, 1, 2, 3], tile + 1, 1),  # the last tile: no op
        (tile + 40, [0x9A, 0x37], tile + 42, 1),  # mid-thread
        (tile + 45, [0x9A, 0x37], tile + 46, 1),  # the thread's last byte
        (tile + 46, [0xFE, 1, 2, 3], tile + 47, 1),  # the next thread's
        (tile + 40, [0x9A, 0x37], tile + 42, 0),  # one byte on
        (m - 2, [0xFE, 1], m - 1, 0),  # past the row's end
    ]
    data = np.full((len(rows), m), 0xC1, np.uint8)
    data[:, :15] = 0
    for r, (at, op, clen, hit) in enumerate(rows):
        data[r, at: at + len(op)] = op
        peek = at + {0xC1: 1, 0x9A: 2, 0xFE: 4}[op[0]]
        if peek + 1 - hit < m:
            data[r, peek: peek + 2] = [0x6A, 0xC1] if hit else [0xC1, 0x6A]
    return (data, np.array([r[2] for r in rows], np.int32),
            [r[3] for r in rows])


def end_peek_segments(seg: int, tile: int = 4096, seed: int = 19):
    """K1's segment-mode edge cases for the alpha peek after a segment's
    last op (mode noalpha): native RGB encodes packed ``seg`` bytes apart
    in a 32768-byte row, one in four with its marker's first byte
    alpha-range, one with a cut RGB op whose operands and peek lie in the
    marker, one with the byte one past the peek alpha-range; at seg 128 a
    segment whose cut RGB op peeks past its end (where the next image's
    header reads 'q', alpha-range), at seg > tile one whose cut op crosses
    the first tile's edge. Returns ((1, 32768) uint8, segment lengths (1,
    32768 // seg) int32 of the flagged row, and the lengths of only the
    segments that must not flag)."""
    from .. import native

    rng = np.random.default_rng([seed, seg])
    k = 32768 // seg
    streams = []
    for j in range(min(k, 16)):
        n = 2 * (j + 2)
        s = bytearray(native.encode(_smooth(rng, n, 3), n, 1, 3, 0, 0))
        if j % 4 == 1:
            s = s[:-8] + bytes([0xFE, 5, 6, 7, 0x6A, 0, 0, 0, 1])
        else:
            s[-8 + (j % 4 == 3)] = 0x6A
        streams.append(bytes(s))
    quiet = [j for j in range(len(streams)) if j % 4 == 3]
    if seg == 128:  # the RGB op at 125: the peek would be at 129
        streams[5] = streams[5][:15] + bytes([0xC1] * 110 + [0xFE, 1, 2])
        quiet.append(5)
    elif seg > tile:
        streams[0] = (streams[0][:15] + bytes([0xC1] * (tile - 17))
                      + bytes([0xFE, 1, 2, 3, 0x6A, 0, 0, 0, 0, 0, 0, 1]))
    data = np.zeros((1, 32768), np.uint8)
    slens = np.zeros((1, k), np.int32)
    for j, s in enumerate(streams):
        if len(s) > seg:
            raise AssertionError(f"a stream of {len(s)} bytes in seg {seg}")
        data[0, j * seg: j * seg + len(s)] = np.frombuffer(s, np.uint8)
        slens[0, j] = len(s) - 8 if not (seg == 128 and j == 5) else 126
    calm = np.zeros_like(slens)
    calm[:, quiet] = slens[:, quiet]
    return data, slens, calm

