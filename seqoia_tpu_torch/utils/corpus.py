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
