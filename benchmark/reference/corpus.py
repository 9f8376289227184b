"""Seeded synthetic images shaped like the qoi-bench suite, made on a device.

A frozen copy of the generators of ``seqoia_tpu_torch/utils/corpus.py``
(``_icon``, ``_pngimg``, ``_photo``, ``_screenshot``, ``_texture``,
``_mono_doc`` and ``make_corpus``'s RGBA photo) at commit
3cb6c7040ff08e3b59fac3692353cf41f41151ef, rewritten in PyTorch with the
same formulas so that the pixels are made on the card: scalar draws (shape
centres, colours, block heights) come from a NumPy generator on the host,
every per-pixel draw from one ``torch.Generator`` on the device, both seeded
from the run's seed. The random streams differ from the original's, so the
pixels do too; the content classes, their sizes and their compression
profile are the original's. Float work is float32 (the original's is
float64); nothing depends on the difference.

``make_images`` builds the images a configuration lists, in its order.
"""

from __future__ import annotations

import numpy as np
import torch


def _grid(h, w, dev):
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(
        h, w)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(
        h, w)
    return yy, xx


def _normal(gen, shape, sd):
    return torch.randn(shape, generator=gen, device=gen.device) * sd


def _u8(img):
    return img.clamp(0, 255).to(torch.uint8)


def icon(rng, gen, size, n_shapes, glow_w=0.2, glow_peak=0.45, fuzz=1.5,
         grad=0.25):
    """Glossy icons: a transparent field, vertical-gradient disks with a
    1.5 px antialiased rim, and translucent glow rings whose alpha steps stay
    inside SQOA's one-byte ALPHA range while per-pixel fuzz defeats
    ``.qoi``'s INDEX hits."""
    dev = gen.device
    img = torch.zeros((size, size, 4), device=dev)
    yy, xx = _grid(size, size, dev)
    for _ in range(n_shapes):
        cx, cy = (int(v) for v in rng.integers(size // 8, size - size // 8, 2))
        r = int(rng.integers(size // 6, size // 3))
        col = rng.integers(60, 256, 3).astype(np.float32)
        d = torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        gw = max(2.0, glow_w * r)
        ga = ((r * (1 + glow_w) - d) / gw).clamp(0, 1) * glow_peak
        gm = (ga > 0) & (d > r)
        if fuzz > 0:
            ga = torch.where(
                gm, (ga + _normal(gen, (size, size), fuzz / 255)).clamp(0, 1),
                ga)
        repl = gm & (ga * 255 > img[..., 3])
        for c in range(3):
            img[..., c] = torch.where(repl, float(col[c]) * 0.6, img[..., c])
        img[..., 3] = torch.where(repl, ga * 255, img[..., 3])
        a = ((r - d) / 1.5).clamp(0, 1)
        g = 1 - grad * (yy - (cy - r)) / max(1, 2 * r)
        for c in range(3):
            img[..., c] = torch.where(a > 0, float(col[c]) * g.clamp(0, 1),
                                      img[..., c])
        img[..., 3] = torch.where(a > 0, torch.maximum(img[..., 3], a * 255),
                                  img[..., 3])
    return _u8(img)


def pngimg(rng, gen, size, n_shapes):
    """Photo objects matted onto transparency: the icon's alpha over
    photo-grained interiors."""
    img = icon(rng, gen, size, n_shapes, glow_w=0.25,
               glow_peak=0.4).to(torch.float32)
    mask = img[..., 3:] > 200
    grain = _normal(gen, (size, size, 1), 5) + _normal(gen, (size, size, 3),
                                                       2.0)
    img[..., :3] = torch.where(mask, img[..., :3] + grain, img[..., :3])
    return _u8(img)


def photo(rng, gen, width, height, luma_sd=8.0, chroma_sd=2.5,
          plateau=0.35):
    """Photo-like RGB: smooth gradients, grain that keeps ``.qoi``'s DIFF
    window from firing, and posterized plateau bands (runs in both
    codecs)."""
    w, h, dev = width, height, gen.device
    yy, xx = _grid(h, w, dev)
    k = [int(rng.integers(1, 40)) for _ in range(3)]
    base = torch.stack([
        120 + 80 * torch.sin(xx / (40 + k[0])),
        120 + 80 * torch.cos(yy / (30 + k[1])),
        120 + 80 * torch.sin((xx + yy) / (50 + k[2])),
    ], dim=-1)
    img = base + _normal(gen, (h, w, 1), luma_sd)
    img += _normal(gen, (h, w, 3), chroma_sd)  # in place: one buffer less
    if plateau > 0:
        m = (torch.sin(xx / 97.0 + 2.1) + torch.cos(yy / 71.0)
             > (1 - 2 * plateau))
        img = torch.where(m[..., None], torch.round(base / 16) * 16, img)
    return _u8(img)


def photo_rgba(rng, gen, width, height):
    """A photo with a mostly opaque alpha plane: 1% of the pixels dip by
    8-15, inside SQOA's ALPHA range (watermark-like)."""
    img = photo(rng, gen, width, height)
    dev = gen.device
    dips = torch.rand((height, width), generator=gen, device=dev) < 0.01
    depth = torch.randint(8, 16, (height, width), generator=gen, device=dev)
    a = (255 - torch.where(dips, depth, 0)).to(torch.uint8)
    return torch.cat([img, a[..., None]], dim=-1)


def screenshot(rng, gen, width, height):
    """UI content: flat margins (BIGRUN wins), text-speckle blocks,
    photo-like image blocks and flat panels."""
    w, h, dev = width, height, gen.device
    img = torch.empty((h, w, 3), device=dev)
    img[:] = torch.as_tensor(rng.integers(235, 256, 3), dtype=torch.float32,
                             device=dev)
    x0, x1 = w // 5, w - w // 5
    y = h // 12
    while y < h - h // 12:
        bh = int(rng.integers(h // 12, h // 5))
        kind = rng.random()
        if kind < 0.45:  # text block: sparse speckle every third row
            rows = torch.arange(y, min(y + bh, h), 3, device=dev)
            shape = (rows.numel(), x1 - x0)
            mask = torch.rand(shape, generator=gen, device=dev) < 0.05
            sub = torch.randint(8, 28, shape, generator=gen, device=dev)
            img[rows, x0:x1] -= torch.where(mask, sub, 0)[..., None].to(
                img.dtype)
        elif kind < 0.75:  # image block: a photo-like region
            yy2, xx2 = _grid(min(bh, h - y), x1 - x0, dev)
            base = torch.stack([
                140 + 60 * torch.sin(xx2 / 23.0),
                140 + 60 * torch.cos(yy2 / 17.0),
                140 + 60 * torch.sin((xx2 + yy2) / 31.0),
            ], dim=-1)
            grain = _normal(gen, base.shape[:2] + (1,), 8) + _normal(
                gen, base.shape, 2.5)
            img[y: y + bh, x0:x1] = base + grain
        else:  # flat panel with a border
            shade = torch.as_tensor(rng.integers(190, 250, 3),
                                    dtype=torch.float32, device=dev)
            img[y: y + bh, x0:x1] = shade
            img[y, x0:x1] = shade - 40
        y += bh + int(rng.integers(h // 24, h // 10))
    return _u8(img)


def texture(rng, gen, width, height):
    """Game-texture-like: a periodic pattern with grain, and full-width
    flat bands (atlas padding: long runs)."""
    w, h, dev = width, height, gen.device
    yy, xx = _grid(h, w, dev)
    base = 96 + 48 * torch.sin(xx / 9.1) * torch.cos(yy / 7.3)
    img = base[..., None] + _normal(gen, (h, w, 1), 11)
    img = img + _normal(gen, (h, w, 3), 2.5)
    for _ in range(5):
        py = int(rng.integers(0, h - h // 8))
        img[py: py + h // 10] = float(rng.integers(40, 200))
    return _u8(img)


def mono_doc(rng, gen, width, height):
    """A grayscale document scan (one channel): a flat page, text speckle
    every third row and a gradient figure."""
    w, h, dev = width, height, gen.device
    img = torch.full((h, w, 1), 245.0, device=dev)
    rows = torch.arange(h // 10, h - h // 10, 3, device=dev)
    shape = (rows.numel(), w - 2 * (w // 8))
    mask = torch.rand(shape, generator=gen, device=dev) < 0.18
    sub = torch.randint(60, 200, shape, generator=gen, device=dev)
    img[rows, w // 8: w - w // 8, 0] -= torch.where(mask, sub, 0).to(
        img.dtype)
    _, xx2 = _grid(h // 4, w // 3, dev)
    img[h // 2: h // 2 + h // 4, w // 3: 2 * (w // 3), 0] = (
        170 + 50 * torch.sin(xx2 / 19.0) + _normal(gen, (h // 4, w // 3), 4))
    return _u8(img)


GENERATORS = {"icon": icon, "pngimg": pngimg, "photo": photo,
              "photo_rgba": photo_rgba, "screenshot": screenshot,
              "texture": texture, "mono_doc": mono_doc}


def _size_args(spec):
    if spec["generator"] in ("icon", "pngimg"):
        if spec["width"] != spec["height"]:
            raise ValueError(f"{spec['category']}: icons are square")
        return {"size": spec["width"]}
    return {"width": spec["width"], "height": spec["height"]}


def make_images(specs, seed: int, device, copies: int = 1):
    """The images of a configuration's ``images`` list, ``copies`` times
    over, each a distinct draw: [(category, (h, w, c) uint8 tensor)].

    ``specs``: dicts with ``category``, ``generator`` (a key of
    GENERATORS), ``count``, ``width``, ``height`` and optional ``args``
    (the generator's keyword arguments)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed % (1 << 64))
    out = []
    for _ in range(copies):
        for spec in specs:
            make = GENERATORS[spec["generator"]]
            for _ in range(spec["count"]):
                out.append((spec["category"], make(
                    rng, gen, **_size_args(spec), **spec.get("args", {}))))
    return out

