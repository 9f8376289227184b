"""sqoabench-compatible benchmark harness
(``seqoia_tpu/utils/bench_harness.py``).

Mirrors the reference harness's workload, flags and report format
(reference: sqoabench.c:301-684): walk a directory of .png files
(recursively unless --norecurse), roundtrip-verify every image, then time
decode/encode across codecs with one discarded warmup run, aggregating
per-directory and grand totals in the familiar table:

          decode ms   encode ms   decode mpps   encode mpps   size kb    rate

Codecs compared: png (PIL, or the numpy PNG codec without it, standing in
for libpng/stbi), qoi (the native codec, compat mode), sqoa (the native
codec) and sqoa:cuda (the port's card path, one image a call).

Every timed call is a public call that returns host arrays or bytes, so
each time includes the copies to and from the card and the
synchronisation they imply: no lazy tensor is ever timed.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np


@dataclasses.dataclass
class Totals:
    count: int = 0
    px: int = 0
    raw: int = 0
    decode_ns: dict = dataclasses.field(default_factory=dict)
    encode_ns: dict = dataclasses.field(default_factory=dict)
    size: dict = dataclasses.field(default_factory=dict)
    # pixels and raw bytes of the images each codec coded (qoi skips mono)
    codec_px: dict = dataclasses.field(default_factory=dict)
    codec_raw: dict = dataclasses.field(default_factory=dict)

    def add(self, codec, dec_ns, enc_ns, size, px, raw):
        self.decode_ns[codec] = self.decode_ns.get(codec, 0) + dec_ns
        self.encode_ns[codec] = self.encode_ns.get(codec, 0) + enc_ns
        self.size[codec] = self.size.get(codec, 0) + size
        self.codec_px[codec] = self.codec_px.get(codec, 0) + px
        self.codec_raw[codec] = self.codec_raw.get(codec, 0) + raw


def _time_loop(fn, runs, nowarmup):
    """Timed repeats; run 0 is discarded unless --nowarmup
    (reference: sqoabench.c:394-406)."""
    n = runs if nowarmup else runs + 1
    times = []
    for i in range(n):
        t0 = time.perf_counter_ns()
        fn()
        dt = time.perf_counter_ns() - t0
        if nowarmup or i > 0:
            times.append(dt)
    return sum(times) // max(len(times), 1)


def bench_image(path, runs, opts, cuda_codec=None, scratch_png=None):
    """Time one PNG through every codec: ({codec: (decode ns, encode ns,
    size)}, pixels, raw bytes). The png codec's encode writes
    ``scratch_png``."""
    from .. import native
    from ..io import png as pngio

    pixels, w, h, ch = pngio.read_image(path)
    if ch == 3:
        # match the reference bench: stbi loads forced to RGBA when alpha
        # is plausible; we keep 3->4 forcing parity (sqoabench.c:418-426)
        rgba = np.empty((w * h, 4), np.uint8)
        rgba[:, :3] = pixels.reshape(-1, 3)
        rgba[:, 3] = 255
        pixels, ch = rgba.reshape(-1), 4
    px = w * h
    raw = px * ch

    results = {}
    sqoa = native.encode(pixels, w, h, ch, 0, 0)
    qoi = native.encode(pixels, w, h, ch, 0, 1)

    if not opts.get("noverify"):
        back, _ = native.decode(sqoa, ch)
        if not np.array_equal(back, pixels):
            raise RuntimeError(f"roundtrip verification failed: {path}")

    codecs = {}
    if not opts.get("nopng"):
        codecs["png"] = {
            "decode": lambda: pngio.read_image(path),
            "encode": lambda: pngio.write_image(scratch_png, pixels, w, h,
                                                ch),
            "size": os.path.getsize(path),
        }
    if qoi is not None:  # the encoder refuses mono .qoi (seqoia.h:477-480)
        codecs["qoi"] = {
            "decode": lambda: native.decode(qoi, ch),
            "encode": lambda: native.encode(pixels, w, h, ch, 0, 1),
            "size": len(qoi),
        }
    codecs["sqoa"] = {
        "decode": lambda: native.decode(sqoa, ch),
        "encode": lambda: native.encode(pixels, w, h, ch, 0, 0),
        "size": len(sqoa),
    }
    if cuda_codec is not None:
        codecs["sqoa:cuda"] = {
            "decode": lambda: cuda_codec.decode(sqoa, ch),
            "encode": lambda: cuda_codec.encode(pixels, w, h, ch),
            "size": len(sqoa),
        }

    for name, c in codecs.items():
        dec_ns = enc_ns = 0
        if not opts.get("nodecode"):
            dec_ns = _time_loop(c["decode"], runs, opts.get("nowarmup"))
        if not opts.get("noencode"):
            enc_ns = _time_loop(c["encode"], runs, opts.get("nowarmup"))
        results[name] = (dec_ns, enc_ns, c["size"])
    return results, px, raw


def print_table(title, totals: Totals, opts):
    print(f"## {title} — {totals.count} images, "
          f"{totals.px / 1e6:.1f} Mpx total")
    print(f"{'':14s}{'decode ms':>11s}{'encode ms':>11s}"
          f"{'decode mpps':>13s}{'encode mpps':>13s}{'size kb':>10s}{'rate':>7s}")
    # totals are averaged per image unless --noaverage (sqoabench.c:306)
    n = 1 if opts.get("noaverage") else max(totals.count, 1)
    for codec in totals.size:
        dec_ns = totals.decode_ns.get(codec, 0)
        enc_ns = totals.encode_ns.get(codec, 0)
        dec_ms = dec_ns / 1e6 / n
        enc_ms = enc_ns / 1e6 / n
        px = totals.codec_px[codec]
        dmpps = px / (dec_ns / 1e3) if dec_ns else 0.0
        empps = px / (enc_ns / 1e3) if enc_ns else 0.0
        kb = totals.size[codec] // 1024
        rate = 100.0 * totals.size[codec] / max(totals.codec_raw[codec], 1)
        print(f"{codec:14s}{dec_ms:11.1f}{enc_ms:11.1f}"
              f"{dmpps:13.1f}{empps:13.1f}{kb:10d}{rate:6.1f}%")
    print()


def bench_directory(root, runs=3, opts=None, use_cuda=False, device="cuda"):
    """Walk ``root`` for .png files, bench each, print per-dir + grand
    totals (reference: sqoabench.c:549-684). With ``use_cuda`` the port's
    card path (on ``device``) joins the table as ``sqoa:cuda``."""
    opts = opts or {}
    cuda_codec = _CudaCodec(device) if use_cuda else None
    grand = Totals()

    with tempfile.TemporaryDirectory() as tmp:
        scratch_png = os.path.join(tmp, "bench_out.png")
        for dirpath, dirnames, filenames in os.walk(root):
            if opts.get("norecurse") and dirpath != root:
                continue
            pngs = sorted(f for f in filenames if f.lower().endswith(".png"))
            if not pngs:
                continue
            dir_tot = Totals()
            for fname in pngs:
                res, px, raw = bench_image(
                    os.path.join(dirpath, fname), runs, opts, cuda_codec,
                    scratch_png)
                for t in (dir_tot, grand):
                    t.count += 1
                    t.px += px
                    t.raw += raw
                    for codec, (d, e, s) in res.items():
                        t.add(codec, d, e, s, px, raw)
            if not opts.get("onlytotals"):
                print_table(dirpath, dir_tot, opts)
    print_table(f"# Grand total {root}", grand, opts)
    return grand


class _CudaCodec:
    """Thin adapter running single images through the port's card path
    (``seqoia_tpu/utils/bench_harness.py:_TpuCodec``)."""

    def __init__(self, device="cuda"):
        import seqoia_tpu_torch as st

        self._st, self._device = st, device

    def decode(self, stream, channels):
        return self._st.decode(stream, channels, backend="cuda",
                               device=self._device)

    def encode(self, pixels, w, h, ch):
        return self._st.encode(pixels, self._st.SqoaDesc(w, h, ch, 0, 0),
                               backend="cuda", device=self._device)
