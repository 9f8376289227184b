"""PNG/JPEG load/save for the converter CLI and bench harness
(``seqoia_tpu/io/png.py``).

The reference tooling leans on stb_image/stb_image_write/tiny_jpeg
(reference: sqoaconv.c:22-34); here PIL plays that role where it is
installed. Without PIL the module reads and writes 8-bit PNGs of colour
types 0/2/4/6 with numpy and zlib, a row at a time, fast enough for
multi-megapixel images: filter types None and Up are elementwise, Sub is a
per-channel cumulative sum mod 256 along the row, and Avg and Paeth loop
over the pixels of the row. JPEG output needs PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    from PIL import Image

    _HAVE_PIL = True
except ImportError:
    _HAVE_PIL = False

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type <-> channels (8-bit only): gray, RGB, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLTYPE = {c: t for t, c in _CHANNELS.items()}


def read_image(path: str):
    """Load an image file -> (flat uint8 pixels, width, height, channels)."""
    if _HAVE_PIL:
        img = Image.open(path)
        if img.mode == "P":
            img = img.convert("RGBA")
        elif img.mode not in ("L", "LA", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        h, w, c = arr.shape
        return arr.reshape(-1).copy(), w, h, c
    return _read_png_numpy(path)


def write_image(path: str, pixels, width: int, height: int, channels: int,
                quality: int = 90) -> None:
    """Save flat uint8 pixels as PNG, or as JPEG (PIL only) by extension."""
    arr = np.asarray(pixels, dtype=np.uint8).reshape(height, width, channels)
    jpeg = path.lower().endswith((".jpg", ".jpeg"))
    if _HAVE_PIL:
        mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
        img = Image.fromarray(arr.squeeze(2) if channels == 1 else arr, mode)
        if jpeg:
            if channels in (2, 4):
                img = img.convert("RGB")
            img.save(path, quality=quality)
        else:
            img.save(path)
        return
    if jpeg:
        raise RuntimeError("JPEG output requires PIL")
    _write_png_numpy(path, arr)


# -- PNG with numpy and zlib ------------------------------------------------

def _unfilter_avg(line, prev, bpp):
    """Avg: x + floor((a + b) / 2), a the unfiltered byte bpp to the left."""
    out = np.empty_like(line)
    prev = prev.astype(np.int32)
    out[:bpp] = (line[:bpp] + (prev[:bpp] >> 1)) & 255
    for x in range(bpp, len(line), bpp):
        a = out[x - bpp: x].astype(np.int32)
        out[x: x + bpp] = (line[x: x + bpp] + ((a + prev[x: x + bpp]) >> 1)) \
            & 255
    return out


def _unfilter_paeth(line, prev, bpp):
    """Paeth: x + the nearest of a, b, c to a + b - c (ties a, then b)."""
    out = np.empty_like(line)
    prev = prev.astype(np.int32)
    out[:bpp] = (line[:bpp] + prev[:bpp]) & 255  # a = c = 0: b wins
    for x in range(bpp, len(line), bpp):
        a = out[x - bpp: x].astype(np.int32)
        b, c = prev[x: x + bpp], prev[x - bpp: x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[x: x + bpp] = (line[x: x + bpp] + pred) & 255
    return out


def _read_png_numpy(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        ctype = data[pos + 4: pos + 8]
        chunk = data[pos + 8: pos + 8 + length]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk[:13])
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, coltype, _, _, interlace = hdr
    if depth != 8 or coltype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs of colour "
                         f"type 0/2/4/6 read without PIL (depth {depth}, "
                         f"type {coltype}, interlace {interlace})")
    ch = _CHANNELS[coltype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(w, ch), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:
            cur = line + prev  # uint8: mod 256
        elif ft == 3:
            cur = _unfilter_avg(line.astype(np.int32), prev, ch)
        elif ft == 4:
            cur = _unfilter_paeth(line.astype(np.int32), prev, ch)
        else:
            raise ValueError(f"{path}: bad filter type {ft} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(-1), w, h, ch


def _write_png_numpy(path: str, arr: np.ndarray) -> None:
    """Filter type None on every row, zlib level 6."""
    h, w, c = arr.shape
    raw = np.zeros((h, w * c + 1), np.uint8)
    raw[:, 1:] = arr.reshape(h, w * c)

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLTYPE[c],
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
