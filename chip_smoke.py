#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seqoia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the port from ``seqoia_tpu_torch/csrc`` (one nvcc
   per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main paths give it: integer data, so the comparison is
   bit-exact (tolerance 0). SQOA: K1 decode front, K2 placement with its
   decode (the gray source at 4 channels through the gray-to-RGBA
   conversion too) and encode epilogues, K3 encode front, K6 placement
   fill (which no decode calls any more). QOI (.qoi): the arguments of the
   first launch of K5 (compaction), K2 (the decode's placement and
   emission), K7 (slot last writer), each K8 (scan) combine and K11 (the
   fused fixpoint pass: its first and last pass, the final values and its
   check), recorded during one
   decode_stream_compat_batched / encode_stream_batched(compat=True) call
   per photo workload (K2's EPI_ENCQ launch also beside the K6 spread and
   torch byte emission it replaced), and of K9 (the sequential decoder) in
   the value chain's decode, and on its ops at row totals on K9's chunk and
   ring edges; K9's mono step at the mono path's full-size launches against
   native.decode's pixels at every op, and at the BatchDecoder list's two
   mono classes (32 rows of 1024x1024 each) also against its plain version
   walking host copies of the same tensors, as at edge rows (no op, one op,
   all 128 slots, runs to the row's end), 64 short rows and 2048 rows of
   64x64 streams of generated mono .qoi ops and one row at totals on the
   chunk and ring edges; every K9 launch re-launched REPEATS times; the
   latency of one dependent shared-memory load (K9's chain bound, a
   one-thread chase through a 128-entry table); K8 segmod, sum and fill
   and K7 at 128 slots (not on the path) at the decode's op shape. Large
   images and icons:
   K4 at the three strides, K1 in segment mode in its three modes, and K1,
   K2 and K3 at the first launch of every distinct shape that
   encode_large, decode_large, the two shard forms (K3's carries, rows as
   shards) and BatchDecoder give them (the icon classes, the mixed list and
   a page loader's call: 128 gray pages at the benchmark's rvlcdip shapes
   at channels=3, K1 in mono mode, then K2's gray-to-RGB conversion, each
   page held to its gray replicated and the call's launches and route
   counters counted), checked on the arguments of that launch in one
   uncounted pass over those calls, and K2, K3 and K4 at every distinct
   launch of BatchEncoder on the batch-encode lists; K1 on a stream whose
   pixel counts pass 2**31. K2's four conversion epilogues (gray to 4 and
   3 channels, colour to 1 and 2) at the page call's shape and at a
   Kodak-sized .qoi shape, each also against the route they replaced (K6,
   then the channels as int64 torch ops), timed beside it. K1, K3, K5, K7,
   K8 and K11 (look-back kernels, whose faults are races) also at edge
   shapes (EDGE_SHAPES: K3 in
   colch 1 and 3 with and without shard carries, pixels that change often,
   rarely and never, n_valid varied by row; every K8 combine, K11 on
   random ops, K5 with all-0, all-1, 35% and last-only masks, K7 with 64
   and 128 slots, four n_live,
   three kinds of hashes, dense and sparse queries; K1 in its three modes on
   rows around its 4096-byte tile, tokens across tile edges, padding far
   past the stream, an n_max that cuts the last op, 37 short rows; K1's
   segment mode in its three modes at every seg from 128 to 32768 with empty
   segments, cuts at seg_px and a length to the segment's end; inputs off
   16-byte boundaries; K2 with every epilogue and K6 at _engine_edge_cases:
   an entry on a tile's first slot, a tile with no entry, tiles of 4096
   entries, totals of 0, rows of different totals, n_out not a multiple of
   the tile, RGB words across a tile edge, on fresh storage and 4 bytes past
   a 16-byte boundary), and every recorded .qoi launch of K2, K5-K8 and
   K11, every SQOA launch of K2, K3 and K6, every SQOA, large-image, icon,
   page and batch-encode launch of K1 (both modes), K2 and K3, every
   conversion epilogue launch and every K9 mono launch re-launched REPEATS
   times, each output bitwise equal to the first;
   their times also with the L2 flushed before each launch, K1's, K2's,
   K3's, K6's and K7's also as device time from a torch.profiler trace
   (without the host's launch overhead), and K8 sum's beside torch.cumsum at
   one row and at 32. K10 (the sequential REF decoder) against its plain
   version at the JAX tests' hand-made REF streams (replay, mid-operand
   teleport, negative start, window spent, mono), 40 seeded encodes with
   REF bytes injected, 64 64x64 streams of the REF maker
   (utils/corpus.ref_sqoa) and the edge streams of K10's chunks at its own
   chunk size (utils/corpus.ref_edge_streams), each at channels 0-4, and at
   the 2048x2048 gray+alpha stream and the 4096x4096 RGBA photo's, both
   with REF spliced in, err and the ops walked included; the two full-size
   streams also against native.decode's pixels; every K10 launch
   re-launched REPEATS times, its ns an op and chain bound (its ops times
   one dependent shared-memory load) printed, and its registers, spills
   and shared memory as ptxas and the library report them; the latency of
   one dependent __ldg byte read within 4 KB and over 64 MB
   (k10_ldg_chase), what a walk that reads the stream from global memory
   pays a byte.
3. Resets the kernels' launch counters and drives the SQOA path through the
   public entry points: one 4096x4096 RGBA photo-class image, a batch of 32
   1024x1024 RGB photos (decode_stream_batched / encode_stream_batched) and
   one 2048x2048 gray+alpha image (decoded as stored and with 4 forced
   channels); reads the counters; resets them again and drives the .qoi
   path: the same RGBA photo (seqoia_tpu_torch.encode / decode with
   qoi_compat=1), the same 32 photos as .qoi (encode_stream_batched with
   compat=True, decode_stream_compat_batched), the 61-link INDEX chain that
   the fixpoint cannot settle in its 12 passes, and a 2000-link chain of
   INDEX reads of DIFF-derived values, which its alpha-speculated restart
   cannot settle either (one resolution per link), so K9 decodes it. Resets
   them again and drives the large-image path: one 16384x8192 RGB
   photo-class image (134 Mpx, assembled from two seeded 4096x4096 tiles and
   their flips) through encode_large, decode_large and both shard forms at 4
   shards, one 8192x8192 gray image and the 2048x2048 gray+alpha image
   through encode_large and decode_large. Resets them again and drives the
   icon path: 4096 RGBA and 4096 RGB 64x64 icons and 2048 gray 64x64 tiles
   through BatchDecoder, then one mixed call (icons of two sizes, four
   1024x1024 photos as SQOA and as .qoi, a stream with a REF op, a bad
   header). Resets them again and drives the batch-encode path: BatchEncoder
   on the icon classes' pixels, the 32 photos, the RGBA photo with the
   gray+alpha scan, the photos as .qoi and a mixed list with an image
   without pixels and an invalid desc, each list cold and warm. Resets
   them again and drives the mono
   .qoi path: one 4096x4096 generated gray+alpha stream through
   seqoia_tpu_torch.decode and 64 1024x1024 ones with the 32 photos as .qoi
   through BatchDecoder. Resets them again and drives the REF path: the two
   full-size REF streams through seqoia_tpu_torch.decode with
   SEQOIA_REF_CUDA=1 (K1 flags them, K10 decodes them), native.decode timed
   beside each. Resets them again and drives the mesh path: the 134 Mpx
   RGB image through encode_large, decode_large and both shard forms, and
   BatchDecoder and BatchEncoder on the 32 photos, the icon classes, the
   photos as .qoi and the color icons as .qoi, each without a mesh and with
   mesh= (every card, or cuda:0 four times on one card), the mesh's output
   byte-equal to the other's. Resets them again
   and drives the tooling path through seqoia_tpu_torch.cli.main: corpus
   (31 PNGs), convert of each to .sqoa and .qoi and back, every file and
   exit code equal to convert --native's, bench --cuda (3 runs) and fuzz
   --cuda (1000 streams, without and with SEQOIA_REF_CUDA=1); then bench
   --cuda BENCH_RUNS times more outside the counters' census, for its
   tables and their spread. Then times BatchDecoder on the photos and the
   icons as .qoi under each .qoi batch policy (SEQOIA_COMPAT_CUDA 1, 0 and
   auto; the paths above run with 1). Resets the counters again and drives
   the stream-end path: the edge streams of tests/test_torch_stream_end.py
   (every last op at channels 1-4, an alpha-range byte at each byte of the
   end marker, where the reference's alpha peek after the last op may land)
   and END_FUZZ seeded malformed streams through decode, decode_large,
   decode_large_shardmap (4 shards, and mesh=(cuda:0,) * 4), BatchDecoder
   and decode with SEQOIA_REF_CUDA=1, at out_ch 0, 2 and 4, every output
   equal to native.decode's; then holds each of its K1 (both modes, all
   three modes of the automaton) and K10 launches against the plain
   version on host copies of the launch's arguments, bitwise. Every stream
   and every pixel the card returns is held byte-exact against the port's
   native C codec. Fails if a kernel of a
   path was not launched on it, if a .qoi stream or an icon went to the host
   decoder, if the shard forms differ from the unsharded ones, if an encode
   call or a BatchEncoder class ran more than one K2 (or, SQOA, more than
   one K3) or ran K2 at another length than the exact one, or if
   BatchEncoder ran K4 other than once a class of stride 1-3.
4. Prints the card's name and power limit, each phase's Mpx/s, each .qoi
   workload's fixpoint (converged rows and passes, the rows settled after it
   and the resolutions that took) beside the INDEX-chain depth that
   ``native.compat_probe`` measures on its streams, the BatchDecoder's and
   BatchEncoder's ``last_timings``, K9's ns an op of the longest row and
   chain bound (its ops times one shared-memory load's latency), the
   steps of the 134 Mpx encode and decode one by one, the peak device
   memory, the bench --cuda table, the fuzz verdicts with the decodes that
   reached K10, the mesh path's seconds without and with the mesh, the
   policies' seconds beside os.cpu_count(), the stream-end path's decodes,
   mismatches, launches held and seconds, each kernel's time beside its
   bound, each kernel's summed gap over the ten paths' launches (Σ(ms − bound), every launch timed in place
   by CUDA events around its C entry point and bounded at its own shape:
   _census), a JSON ``kernels`` line and, last, ``{"ok": true, "device":
   {...}}``.

Any failure exits non-zero; without a CUDA device it exits 2 and prints
no result. Images are synthetic and made from a fixed seed. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
OUT_DIR = "chiprun_out"
REPS = 10  # timed launches per kernel and shape
REPEATS = 50  # re-launches of K1-K3, K5-K8 and K11 held bitwise to the first
BENCH_RUNS = 3  # `bench --cuda` tables outside the census, for their spread
DISPATCH_RUNS = 5  # warm BatchDecoder calls a .qoi policy and list

KERNELS = {
    "K1": ("decode_front_compact", "seqoia_tpu_torch/csrc/frontend.cu",
           "seqoia_tpu/ops/pallas_frontend.py:620"),
    "K1seg": ("decode_front_compact (segment mode)",
              "seqoia_tpu_torch/csrc/frontend.cu",
              "seqoia_tpu/ops/pallas_frontend.py:620"),
    "K2": ("place_emit", "seqoia_tpu_torch/csrc/engine.cu",
           "seqoia_tpu/ops/pallas_engine.py:342"),
    "K3": ("encode_front_compact", "seqoia_tpu_torch/csrc/encode_front.cu",
           "seqoia_tpu/ops/pallas_encode.py:270"),
    "K4": ("pack_words", "seqoia_tpu_torch/csrc/pack.cu",
           "seqoia_tpu/ops/pallas_pack.py:90"),
    "K6": ("place_fill", "seqoia_tpu_torch/csrc/engine.cu",
           "seqoia_tpu/ops/pallas_engine.py:504"),
    "K5": ("compact", "seqoia_tpu_torch/csrc/compact.cu",
           "seqoia_tpu/ops/pallas_engine.py:169"),
    "K7": ("slot_last_writer", "seqoia_tpu_torch/csrc/slots.cu",
           "seqoia_tpu/ops/pallas_slots.py:119"),
    "K8": ("tile_scan", "seqoia_tpu_torch/csrc/scan.cu",
           "seqoia_tpu/ops/pallas_scan.py:123"),
    # no Pallas kernel: the lax.scan of the JAX sequential compat decoder
    "K9": ("sequential_decode", "seqoia_tpu_torch/csrc/sequential.cu",
           "seqoia_tpu/codec/decode_jax.py:93"),
    "K9mono": ("sequential_decode (mono step)",
               "seqoia_tpu_torch/csrc/sequential.cu",
               "seqoia_tpu/codec/decode_jax.py:93"),
    # no Pallas kernel: the lax.scan of the JAX REF decoder
    "K10": ("ref_decode", "seqoia_tpu_torch/csrc/ref.cu",
            "seqoia_tpu/codec/decode_jax.py:186"),
    # no Pallas kernel: the XLA ops of a fixpoint pass around two tile_scans
    "K11": ("op_values", "seqoia_tpu_torch/csrc/fixpoint.cu",
            "seqoia_tpu/codec/decode_compat.py:80"),
}
SQOA_KERNELS = ("K1", "K2", "K3")
QOI_KERNELS = ("K2", "K5", "K7", "K8", "K9", "K11")
LARGE_KERNELS = ("K1", "K2", "K3", "K4")
ICON_KERNELS = ("K1seg", "K2")
ENCODE_KERNELS = ("K2", "K3", "K4", "K5", "K7", "K8")
MONO_KERNELS = ("K2", "K5", "K8", "K9mono")
REF_KERNELS = ("K1", "K2", "K10")
TOOL_KERNELS = ("K1", "K2", "K3", "K5", "K7", "K8", "K10", "K11")
MESH_KERNELS = ("K1", "K1seg", "K2", "K3", "K4", "K5", "K7", "K8", "K11")
END_KERNELS = ("K1", "K1seg", "K2", "K10")


def _images(seed: int = 0):
    """(name, [flat uint8 pixels], width, height, channels) per workload."""
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)

    def with_alpha(img):
        a = np.full(img.shape[:2] + (1,), 255, np.int16)
        dips = rng.random(img.shape[:2]) < 0.01  # within the ALPHA op's +-16
        a[dips] -= rng.integers(8, 16, (int(dips.sum()), 1))
        return np.concatenate([img, a.astype(np.uint8)], axis=-1)

    photo = with_alpha(corpus._photo(rng, 4096, 4096))
    batch = [corpus._photo(rng, 1024, 1024) for _ in range(32)]
    gray = with_alpha(corpus._mono_doc(rng, 2048, 2048))
    return [
        ("photo_rgba", [photo.reshape(-1)], 4096, 4096, 4),
        ("batch_rgb", [b.reshape(-1) for b in batch], 1024, 1024, 3),
        ("gray_alpha", [gray.reshape(-1)], 2048, 2048, 2),
    ]


def _large_images(images, seed: int = 1):
    """(name, flat uint8 pixels, width, height, channels) of the large-image
    path: a 16384x8192 RGB photo assembled from two seeded 4096x4096 tiles
    (the RGBA photo's color planes and a new one) and their flips, an
    8192x8192 gray scan, and the SQOA path's 2048x2048 gray+alpha image."""
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    by_name = {name: px for name, px, *_ in images}
    t0 = by_name["photo_rgba"][0].reshape(4096, 4096, 4)[..., :3]
    t1 = corpus._photo(rng, 4096, 4096)
    big = np.empty((8192, 16384, 3), np.uint8)
    tiles = [t0, t1, t0[::-1], t1[::-1], t1[:, ::-1], t0[:, ::-1],
             t1[::-1, ::-1], t0[::-1, ::-1]]
    for i, t in enumerate(tiles):
        r, c = divmod(i, 4)
        big[r * 4096: (r + 1) * 4096, c * 4096: (c + 1) * 4096] = t
    gray = corpus._mono_doc(rng, 8192, 8192)
    return [
        ("large_rgb", big.reshape(-1), 16384, 8192, 3),
        ("large_gray", gray.reshape(-1), 8192, 8192, 1),
        ("gray_alpha_2048", by_name["gray_alpha"][0], 2048, 2048, 2),
    ]


def _icon_streams(images, qstages, seed: int = 2):
    """The icon path's streams (native encodes): {class: [streams]} for 4096
    RGBA icons, the same icons without alpha and 2048 gray tiles, all
    64x64, the mixed list: icons of two sizes, four 1024x1024 photos as
    SQOA and as .qoi, a stream with a REF op and a bad header; and {class:
    ([flat pixels], channels)} of the three classes."""
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    icons = [corpus._icon(rng, 64, 5, glow_w=0.6, glow_peak=0.5)
             for _ in range(4096)]
    pixels = {
        "icons_rgba": ([i.reshape(-1) for i in icons], 4),
        "icons_rgb": ([np.ascontiguousarray(i[..., :3]).reshape(-1)
                       for i in icons], 3),
        "tiles_gray": ([corpus._mono_doc(rng, 64, 64).reshape(-1)
                        for _ in range(2048)], 1),
    }
    classes = {name: [native.encode(p, 64, 64, ch, 0, 0) for p in px]
               for name, (px, ch) in pixels.items()}
    photos = next(px for name, px, *_ in images if name == "batch_rgb")[:4]
    qoi = next(s for s in qstages if s.name == "batch_rgb_qoi").streams[:4]
    ref = bytearray(classes["icons_rgba"][0])
    ref[15] = 0x05  # a REF op at the first op position
    mixed = (classes["icons_rgba"][1:65]
             + [native.encode(corpus._icon(rng, 32, 3).reshape(-1), 32, 32, 4,
                              0, 0) for _ in range(64)]
             + [native.encode(p, 1024, 1024, 3, 0, 0) for p in photos]
             + list(qoi) + [bytes(ref), b"Sqoa" + bytes(40)])
    return classes, mixed, bytes(ref), pixels


# the benchmark's rvlcdip configuration (benchmark/configs/rvlcdip.json):
# (width, height, pages) of its letter, A4 and landscape pages
PAGES = ((773, 1000, 96), (707, 1000, 24), (1000, 773, 8))
# its kodak24 configuration's loader step: (width, height, photos)
KODAK = (768, 512, 24)


def _page_streams(seed: int = 9):
    """A page loader's call (PAGES: 128 gray document pages, one class of
    n_max 1,048,576): the pages' flat gray pixels and their native SQOA
    streams."""
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    pages = [(corpus._mono_doc(rng, w, h).reshape(-1), w, h)
             for w, h, n in PAGES for _ in range(n)]
    return ([p for p, _, _ in pages],
            [native.encode(p, w, h, 1, 0, 0) for p, w, h in pages])


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _timed(fn, reps: int = REPS):
    """Mean ms of fn() on the card over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_cold(fn, reps: int = REPS):
    """Mean ms of fn() on the card over reps launches, each after a 64 MB
    write that flushes the 50 MB L2 (the time a caller that finds its
    input in device memory, not in L2, sees)."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(reps)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def _device_ms(fn, reps: int = REPS):
    """Mean device time of fn() over reps calls: its kernels and memsets,
    summed from a torch.profiler trace (the time without the host's
    launch overhead, which _timed includes once a call is this short)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type.name == "CUDA")
    return us / 1e3 / reps if us else None  # None: the trace held no event


def _repeats_differ(run, view, first, n: int = REPEATS) -> int:
    """Re-launch run() n times; the number of launches whose outputs
    (view(out): a list of tensors) differ bitwise from first's."""
    import torch

    want = view(first)
    return sum(not all(torch.equal(a, b) for a, b in zip(view(run()), want))
               for _ in range(n))


def _held(run, first, view=lambda o: [o], reps: int = REPS):
    """The race checks and times of a launch beyond its warm time:
    re-launched REPEATS times against ``first``, timed with the L2 flushed
    and as device time."""
    return dict(repeats_differ=_repeats_differ(run, view, first),
                cold_ms=_timed_cold(run, reps), device_ms=_device_ms(run, reps))


def _front_view(out):
    """K1's outputs that its contract defines: totals, has_ref, and the
    keys and payloads below totals."""
    keys, pays, tot, ref = out
    return [tot, ref, _live(keys, tot), _live(pays, tot)]


def _encode_front_view(out):
    """K3's outputs that its contract defines: the three scalars, and the
    offsets, pixels and metas below the entry totals."""
    keys, (cur, meta), et, ct, lc = out
    return [et, ct, lc, _live(keys, et), _live(cur, et), _live(meta, et)]


def _plain_ms(fn, warm: bool = True):
    """(fn(), its ms on the host clock), after one warm-up call (``warm``)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _clock(rates, phase, n_px, fn):
    """fn() on the host clock, ended by a synchronize; appends (phase,
    Mpx/s) to rates and returns fn's result."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rates.append((phase, n_px / (time.perf_counter() - t) / 1e6))
    return out


def _max_err(a, b) -> int:
    """Max |a - b| over integer tensors; a shape mismatch fails."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


class Stages:
    """One workload's inputs (SQOA, or .qoi with ``compat=1``): its native
    streams, the padded byte buffer and the packed pixels on the card, and
    the encode's cap; for .qoi, each stream's ``native.compat_probe`` and,
    after check_qoi_kernels, the fixpoint's stats."""

    def __init__(self, name, pixels, w, h, ch, dev, compat=0):
        import torch

        import seqoia_tpu_torch as st
        from seqoia_tpu_torch import native, spec
        from seqoia_tpu_torch.codec import encode_v2, normalize_pixels_packed
        from seqoia_tpu_torch.codec.encode import pixel_bucket

        self.name, self.w, self.h, self.ch = name, w, h, ch
        self.pixels = pixels
        self.desc = st.SqoaDesc(w, h, ch, 0, compat)
        self.streams = [native.encode(p, w, h, ch, 0, compat) for p in pixels]
        self.n = w * h
        self.colch = self.desc.col_channels
        self.mode = ("mono" if self.colch == 1 else
                     ("alpha" if self.desc.has_alpha else "noalpha"))
        self.out_ch = self.desc.norm_channels
        self.n_max = _pow2(max(self.n, 4))
        m = _pow2(max(len(s) for s in self.streams))
        buf = np.zeros((len(pixels), m), np.uint8)
        for i, s in enumerate(self.streams):
            buf[i, : len(s)] = np.frombuffer(s, np.uint8)
        self.buf_host = buf
        self.data = torch.from_numpy(buf).to(dev)
        self.clen = torch.tensor([len(s) - spec.PADDING_SIZE
                                  for s in self.streams], dtype=torch.int32,
                                 device=dev)
        self.npx = torch.full((len(pixels),), self.n, dtype=torch.int32,
                              device=dev)
        # the encode's power-of-two pixel bucket and K2's output length in
        # an encode, sized from the exact stream totals (the native
        # streams' bodies: SQOA after its header and start byte, .qoi after
        # its header)
        n_pad = pixel_bucket(self.n)
        packed = np.zeros((len(pixels), n_pad), np.int32)
        for i, p in enumerate(pixels):
            packed[i, : self.n] = normalize_pixels_packed(p, self.desc)
        self.packed_host = packed
        self.packed = torch.from_numpy(packed).to(dev)
        body = spec.HEADER_SIZE + (0 if compat else 1)
        self.out_cap = encode_v2.exact_cap(torch.tensor(
            [len(x) - body for x in self.streams]))
        self.probe = ([native.compat_probe(x) for x in self.streams]
                      if compat else None)
        self.fix = None


def check_kernels(stages, dev):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel id: [record per shape]}."""
    import torch

    from seqoia_tpu_torch.codec import decode_v2, encode_v2
    from seqoia_tpu_torch.ops import encode_front, engine, frontend

    rec = {k: [] for k in KERNELS}
    init = (decode_v2._INIT_PACKED,)
    for s in stages:
        bsz = s.data.shape[0]
        # --- K1 -----------------------------------------------------------
        def k1():
            return frontend.decode_front_compact(s.data, s.clen, s.n_max,
                                                 s.mode)
        keys, pays, tot, ref = k1()
        (pk, pp, ptot, pref), p_ms = _plain_ms(
            lambda: frontend.decode_front_plain(s.data, s.clen, s.n_max,
                                                s.mode))
        err = max(_max_err(tot, ptot), _max_err(ref, pref))
        for r in range(bsz):
            t = int(tot[r])
            err = max(err, _max_err(keys[r, :t], pk[r, :t]),
                      _max_err(pays[r, :t], pp[r, :t]))
        if int(ref.max()) != 0:
            raise AssertionError(f"{s.name}: stream flagged foreign")
        n_ops = int(tot.sum())
        rec["K1"].append(dict(
            shape=f"{s.name} {tuple(s.data.shape)} {s.mode}", err=err,
            ms=_timed(k1), plain_ms=p_ms,
            bytes=sum(len(x) for x in s.streams) + 8 * n_ops + 16 * bsz,
            repeats_differ=_repeats_differ(k1, _front_view,
                                           (keys, pays, tot, ref)),
            cold_ms=_timed_cold(k1), device_ms=_device_ms(k1)))
        del pk, pp
        # --- K2 decode epilogue (a gray source also at 4 channels), K6 -----
        npx = s.npx[:, None]
        for out_ch in (s.out_ch, 4) if s.colch == 1 else (s.out_ch,):
            epi = decode_v2._epilogue(s.colch, out_ch)

            def k2():
                return engine.place_emit(keys, [pays], tot, npx, s.n_max,
                                         init, epi)
            out = k2()
            ref_out, p_ms = _plain_ms(lambda: epi.plain(
                engine._fill_plain(keys, [pays], tot, s.n_max, init),
                torch.arange(s.n_max, device=dev)[None, :], npx.long()))
            rec["K2"].append(dict(
                shape=f"{s.name} decode out_ch={out_ch} n_out={s.n_max}",
                err=_max_err(out, ref_out), ms=_timed(k2), plain_ms=p_ms,
                bytes=8 * n_ops + out.numel() * out.element_size(),
                main=out_ch == s.out_ch, **_held(k2, out)))
            del out, ref_out
        if s.colch == 1:
            def k6():
                return engine.place_fill(keys, [pays], tot, s.n_max, init)
            (fk,) = k6()
            (fp,), p_ms = _plain_ms(lambda: engine._fill_plain(
                keys, [pays], tot, s.n_max, init))
            rec["K6"].append(dict(
                shape=f"{s.name} fill n_out={s.n_max}",
                err=_max_err(fk, fp), ms=_timed(k6), plain_ms=p_ms,
                bytes=8 * n_ops + 4 * fk.numel(), **_held(k6, [fk], list)))
            del fk, fp
        del keys, pays
        torch.cuda.empty_cache()
        # --- K3 -----------------------------------------------------------
        def k3():
            return encode_front.encode_front_compact(s.packed, s.npx,
                                                     colch=s.colch)
        ek, (ec, em), et, ect, elc = k3()
        (pk, (pc, pm), pet, pct, plc), p_ms = _plain_ms(
            lambda: encode_front.encode_front_plain(
                s.packed, s.npx, s.colch,
                torch.full((bsz,), encode_front.INIT_PACKED,
                           dtype=torch.int32, device=dev),
                torch.full((bsz,), -1, dtype=torch.int32, device=dev)))
        err = max(_max_err(et, pet), _max_err(ect, pct), _max_err(elc, plc))
        for r in range(bsz):
            t = int(et[r])
            err = max(err, _max_err(ek[r, :t], pk[r, :t]),
                      _max_err(ec[r, :t], pc[r, :t]),
                      _max_err(em[r, :t], pm[r, :t]))
        n_ent = int(et.sum())
        rec["K3"].append(dict(
            shape=f"{s.name} {tuple(s.packed.shape)} colch={s.colch}",
            err=err, ms=_timed(k3), plain_ms=p_ms,
            bytes=4 * s.packed.numel() + 12 * n_ent + 24 * bsz,
            **_held(k3, (ek, (ec, em), et, ect, elc), _encode_front_view)))
        del pk, pc, pm
        # --- K2 encode epilogue, at the main path's output cap -------------
        scal, _ = encode_v2.emit_scalars(s.npx, ect, elc)
        eepi = encode_v2._emit_epilogue(s.colch)
        cap = s.out_cap

        def k2e():
            return engine.place_emit(ek, [ec, em], et, scal, cap,
                                     encode_v2._emit_inits(), eepi)
        out = k2e()
        ref_out, p_ms = _plain_ms(lambda: eepi.plain(
            engine._fill_plain(ek, [ec, em, ek], et, cap,
                               encode_v2._emit_inits()),
            torch.arange(cap, device=dev)[None, :], scal.long()))
        rec["K2"].append(dict(
            shape=f"{s.name} encode colch={s.colch} n_out={cap}",
            err=_max_err(out, ref_out), ms=_timed(k2e), plain_ms=p_ms,
            bytes=12 * n_ent + out.numel(), **_held(k2e, out)))
        del out, ref_out, ek, ec, em
        torch.cuda.empty_cache()
    return rec


def main_path(stages, dev):
    """Decode and encode every workload through the public entry points,
    byte-exact against the native codec. Returns ([(phase, Mpx/s)], [(rows,
    K2's cap, SQOA) per encode call])."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.codec import decode_stream_batched
    from seqoia_tpu_torch.codec import encode_stream_batched

    rates, calls = [], []

    clock = functools.partial(_clock, rates)

    for s in stages:
        if s.name == "batch_rgb":
            bsz = len(s.streams)
            pix, ref = clock(
                "batch decode (decode_stream_batched)", bsz * s.n,
                lambda: decode_stream_batched(
                    torch.from_numpy(s.buf_host).to(dev),
                    s.clen, s.npx, colch=3, out_ch=3, n_max=s.n_max,
                    src_alpha=False))
            pix = pix.cpu().numpy()
            if bool(ref.any()):
                raise AssertionError("batch: stream flagged foreign")
            for i, stream in enumerate(s.streams):
                want, _ = native.decode(stream, 0)
                if not np.array_equal(pix[i, : s.n * 3], want):
                    raise AssertionError(f"batch decode row {i} differs")
            out, total = clock(
                "batch encode (encode_stream_batched)", bsz * s.n,
                lambda: encode_stream_batched(
                    torch.from_numpy(s.packed_host).to(dev), s.npx, colch=3))
            calls.append((bsz, s.out_cap, True))
            if out.shape[1] != s.out_cap:
                raise AssertionError(f"batch encode: K2 ran at {out.shape[1]} "
                                     f"bytes, not the checked {s.out_cap}")
            out, total = out.cpu().numpy(), total.cpu().numpy()
            for i, stream in enumerate(s.streams):
                if out[i, : total[i]].tobytes() != stream[15:]:
                    raise AssertionError(f"batch encode row {i} differs")
            continue
        stream, pixels = s.streams[0], s.pixels[0]
        got, desc = clock(f"{s.name} decode (seqoia_tpu_torch.decode)", s.n,
                          lambda: st.decode(stream, device=dev))
        if not np.array_equal(got, pixels):
            raise AssertionError(f"{s.name}: decode differs")
        if s.colch == 1:
            got4, _ = clock(f"{s.name} decode to 4 channels", s.n,
                            lambda: st.decode(stream, 4, device=dev))
            want4, _ = native.decode(stream, 4)
            if not np.array_equal(got4, want4):
                raise AssertionError(f"{s.name}: 4-channel decode differs")
        enc = clock(f"{s.name} encode (seqoia_tpu_torch.encode)", s.n,
                    lambda: st.encode(pixels, s.desc, device=dev))
        calls.append((1, s.out_cap, True))
        if enc != stream:
            raise AssertionError(f"{s.name}: encode differs")
    return rates, calls


def _chain():
    """The 61-link INDEX chain (tests/test_compat_fixpoint.py): color A
    hashes to slot 0, where the fixpoint's wrong guesses land too, and each
    repeat of A reads the previous INDEX-decoded A, so the fixpoint settles
    one link per pass and cannot finish in 12."""
    a = (25, 0, 0, 255)
    px = [a]
    for c in range(2, 64):
        if c != 43:  # this filler would hash to slot 0
            px += [(c, 40, 0, 255), a]
    return np.array(px, np.uint8).reshape(-1), len(px)


def _value_chain(links: int):
    """``links`` INDEX reads, each of the value a DIFF op derived from the
    INDEX read before it (tests/test_torch_compat.py): neither the
    fixpoint's zero guesses nor the speculated alpha of its restart help,
    so the card settles it in one resolution per link, the worst case."""
    def slot(c):
        return (c[0] * 3 + c[1] * 5 + c[2] * 7 + c[3] * 11) % 64

    px = [(0, 40, 0, 255)]
    for i in range(1, links + 1):
        x = (i % 256, 40 + i // 256, 0, 255)
        z = (0, 200 + 2 * (i // 256), i % 256, 255)
        if slot(z) == slot(x):  # the filler would evict x from the index
            z = (0, 201 + 2 * (i // 256), i % 256, 255)
        px += [x, z, x]
    return np.array(px, np.uint8).reshape(-1), len(px)


def _capture(run):
    """Run ``run()`` with the K2, K5, K7, K8, K9 and K11 wrappers
    recording the arguments of their first launch (K8: per combine; K11: its
    first pass and its last, which may be the restart's rows, the final
    values and its first check). Returns ({kernel: (args, kwargs)}, run's
    result)."""
    from seqoia_tpu_torch.ops import (compact, engine, fixpoint, scan,
                                      sequential, slots)

    seen = {}
    saved = []
    for mod, name, key in (
            (engine, "place_emit", lambda a, k: "K2"),
            (compact, "compact", lambda a, k: "K5"),
            (slots, "slot_last_writer", lambda a, k: "K7"),
            (scan, "tile_scan", lambda a, k: "K8 " + a[1]),
            (sequential, "sequential_decode", lambda a, k: "K9"),
            (fixpoint, "op_values", lambda a, k: (
                "K11 pass" if k.get("hashes", True) else "K11 values")),
            (fixpoint, "settled", lambda a, k: "K11 settled")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _key=key, **k):
            name = _key(a, k)
            seen.setdefault(name, (a, k))
            if name == "K11 pass":
                seen["K11 last pass"] = (a, k)
            return _fn(*a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, rec)
    try:
        out = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seen, out


def _check_qoi_call(key, args, kw, where):
    """Kernel vs plain version on one recorded launch. Returns (kernel id,
    record)."""
    import torch

    from seqoia_tpu_torch.ops import (compact, engine, fixpoint, scan,
                                      sequential, slots)

    kid = key.split()[0]
    library = None
    if kid == "K8":
        arrays, combine = args
        run = lambda: scan.tile_scan(arrays, combine)  # noqa: E731
        got = run()
        want, p_ms = _plain_ms(lambda: scan.tile_scan_plain(arrays, combine))
        err = max(_max_err(g, w) for g, w in zip(got, want))
        repeats = _repeats_differ(run, list, got)
        x = arrays[0]
        nbytes = 8 * len(arrays) * x.numel()
        if combine == "max":
            library = _timed(lambda: torch.cummax(x, -1))
        elif combine == "sum":
            library = _timed(lambda: torch.cumsum(x, -1, dtype=torch.int32))
        shape = f"{where} {combine} {tuple(x.shape)}"
    elif kid == "K5":
        valid, key_, pays = args
        run = lambda: compact.compact(valid, key_, pays)  # noqa: E731
        keys, cp, tot = run()
        (pk, pp, ptot), p_ms = _plain_ms(
            lambda: compact.compact_plain(valid != 0, key_, pays))
        err = _max_err(tot, ptot)
        for r in range(valid.shape[0]):
            t = int(tot[r])
            err = max([err, _max_err(keys[r, :t], pk[r, :t])]
                      + [_max_err(a[r, :t], b[r, :t]) for a, b in zip(cp, pp)])
        repeats = _repeats_differ(
            run, lambda o: [o[2], _live(o[0], o[2])]
            + [_live(p, o[2]) for p in o[1]], (keys, cp, tot))
        kept = int(tot.sum())
        nbytes = valid.numel() + 8 * (1 + len(pays)) * kept + 4 * len(tot)
        if valid.shape[0] == 1:
            rows = [key_[0]] + [p[0] for p in pays]
            library = _timed(lambda: torch.stack(rows)[:, valid[0]])
        shape = (f"{where} {tuple(valid.shape)} payloads={len(pays)} "
                 f"kept={kept}")
    elif kid == "K7":
        h, v, q = args
        n_slots, init = kw.get("n_slots", 64), kw.get("init", 0)
        n_live = kw["n_live"]
        run = lambda: slots.slot_last_writer(h, v, q, n_slots, init,  # noqa
                                             n_live)
        got = run()
        want, p_ms = _plain_ms(lambda: slots.slot_last_writer_plain(
            h, v, q, n_slots, init, n_live))
        err = _max_err(got, want)
        repeats = _repeats_differ(run, lambda o: [o], got)
        idx = torch.arange(h.shape[1], device=h.device)[None, :]
        live = idx < n_live.long()[:, None]
        n_q = int(((q >= 0) & (q < n_slots) & live).sum())
        nbytes = 12 * h.numel() + 4 * n_q
        shape = f"{where} {tuple(h.shape)} slots={n_slots} queries={n_q}"
    elif kid == "K11" and key.endswith("settled"):
        got_, iv = args
        run = lambda: fixpoint.settled(got_, iv)  # noqa: E731
        out = run()
        want, p_ms = _plain_ms(lambda: fixpoint.settled_plain(got_, iv))
        err = _max_err(out, want)
        repeats = _repeats_differ(run, lambda o: [o], out)
        nbytes = 8 * got_.numel() + got_.shape[0]
        shape = f"{where} settled {tuple(got_.shape)}"
    elif kid == "K11":
        lo, hi, iv, tot = args
        with_h = kw.get("hashes", True)
        run = lambda: fixpoint.op_values(lo, hi, iv, tot,  # noqa: E731
                                         hashes=with_h)
        out = run()
        want, p_ms = _plain_ms(lambda: fixpoint.op_values_plain(
            lo, hi, iv, tot, with_h))
        view = (lambda o: list(o)) if with_h else (lambda o: [o[0]])
        err = max(_max_err(g, w) for g, w in zip(view(out), view(want)))
        repeats = _repeats_differ(run, view, out)
        # lo, hi and iv read once, px (and the hashes) written once
        nbytes = (20 if with_h else 16) * lo.numel() + 4 * len(tot)
        shape = (f"{where} {' '.join(key.split()[1:])} {tuple(lo.shape)} "
                 f"ops={int(tot.sum())}")
    elif kid == "K9":
        lo, hi, tot = args
        run = lambda: sequential.sequential_decode(lo, hi, tot)  # noqa: E731
        got = run()
        want, p_ms = _plain_ms(lambda: sequential.sequential_decode_plain(
            lo, hi, tot))
        err = _max_err(got, want)
        repeats = _repeats_differ(run, lambda o: [o], got)
        n_ops = int(tot.sum())
        nbytes = 12 * n_ops + 4 * len(tot)
        shape = f"{where} {tuple(lo.shape)} ops={n_ops}"
    else:  # K2
        keys, pays, tot, scal, n_out, inits, epi = args
        run = lambda: engine.place_emit(keys, pays, tot, scal,  # noqa: E731
                                        n_out, inits, epi)
        got = run()
        err, p_ms = _plain_emit(got, keys, pays, tot, scal, n_out, inits, epi)
        repeats = _repeats_differ(run, lambda o: [o], got)
        n_ent = int(tot.sum())
        nbytes = 4 * (1 + len(pays)) * n_ent + got.numel() * got.element_size()
        shape = (f"{where} epilogue {_EPILOGUES[epi.kind]} "
                 f"rows={keys.shape[0]} n_out={n_out} entries={n_ent}")
        if epi.kind == engine.EPI_ENCQ:
            # the route this launch replaced: a K6 spread of the three
            # streams over the cap, then the compat bytes as torch ops
            from seqoia_tpu_torch.codec import encode_v2

            t = torch.arange(n_out, dtype=torch.int32,
                             device=keys.device)[None, :]
            replaced_ms = _timed(lambda: encode_v2._compat_bytes(
                engine.place_fill(keys, pays, tot, n_out, inits,
                                  fill_keys=True), t, scal))
            del t
    r = dict(shape=shape, err=err, ms=_timed(run), plain_ms=p_ms,
             bytes=nbytes, library_ms=library, main=True)
    if kid == "K2" and args[-1].kind == engine.EPI_ENCQ:
        r["replaced_ms"] = replaced_ms
    if kid in ("K2", "K5", "K7", "K8", "K11"):
        # a race (look-back, shared-memory staging) can hide in one launch:
        # the repeats must agree
        r.update(repeats_differ=repeats, cold_ms=_timed_cold(run))
    if kid in ("K2", "K7", "K11"):
        r["device_ms"] = _device_ms(run)
    if kid == "K9":
        r.update(repeats_differ=repeats, longest=int(tot.max()))
    return kid, r


def check_qoi_kernels(qstages, dev):
    """K2, K5, K7, K8 and K11 against their plain versions at the shapes the
    .qoi path gives them (recorded from one batched decode and one batched
    encode per photo workload), K9 at the value chain's, and, off the path,
    K9 on the value chain's ops at totals on its chunk edges, K8 segmod
    (which K11 took over from the decode), sum and fill and K7 at 128 slots
    at the decode's op shape. Records each photo workload's fixpoint
    stats."""
    import torch

    from seqoia_tpu_torch.codec import (decode_stream_compat_batched,
                                        encode_stream_batched)
    from seqoia_tpu_torch.ops import fixpoint

    rec = {k: [] for k in QOI_KERNELS}
    for s in qstages:
        if s.name == "index_chain":
            continue
        if s.name == "value_chain":
            seen, _ = _capture(lambda: decode_stream_compat_batched(
                s.data, s.clen, s.npx, colch=3, out_ch=4, n_max=s.n_max))
            kid, r = _check_qoi_call("K9", *seen["K9"], f"{s.name} decode")
            rec[kid].append(r)
            (lo, hi, _), _ = seen["K9"]
            rec[kid].append(_k9_held(f"{s.name} ops at chunk-edge totals",
                                     *_k9_edge_rows(lo, hi), 3, False))
            continue
        stats = {}
        seen, (_, conv) = _capture(lambda: decode_stream_compat_batched(
            s.data, s.clen, s.npx, colch=3, out_ch=s.out_ch, n_max=s.n_max,
            stats=stats))
        s.fix = dict(stats, converged=sum(conv.tolist()))
        if "K9" in seen:  # its plain version walks one op per step
            raise AssertionError(
                f"{s.name}: K9 decoded {stats['sequential_rows']} rows; its "
                "plain check needs a small shape")
        for key, (a, k) in seen.items():
            kid, r = _check_qoi_call(key, a, k, f"{s.name} decode")
            rec[kid].append(r)
        # K8's segmod on the two pack_pair words the library pass scanned
        # (r, g; b, a) in the first resolution, its sum and fill on the
        # first, and K7 at 128 slots (the mono index), on the first
        # resolution's slots spread over 128 by the value's low bit
        (lo, hi, iv, tot), _ = seen["K11 pass"]
        w, f = fixpoint.elements_plain(lo, hi, iv, tot)
        rgb, a_f = f & 1, (f >> 1) & 1
        seg, seg_ba = ((w0 & 255) | (f0 << 8) | ((w1 & 255) << 16) | (f1 << 24)
                       for w0, f0, w1, f1 in ((w, rgb, w >> 8, rgb),
                                              (w >> 16, rgb, w >> 24, a_f)))
        seg, seg_ba = seg.to(torch.int32), seg_ba.to(torch.int32)
        del w, f, rgb, a_f
        (h, v, q), kw = seen["K7"]
        wide = [torch.where(x >= 0, x + 64 * (v & 1), -1) for x in (h, q)]
        for key, args, k in (
                ("K8", ((seg,), "segmod"), {}),
                ("K8", ((seg_ba,), "segmod"), {}),
                ("K8", ((seg & 255,), "sum"), {}),
                ("K8", ((seg, (seg >> 8) & 1), "fill"), {}),
                ("K7", (wide[0], v, wide[1]), dict(kw, n_slots=128))):
            kid, r = _check_qoi_call(key, args, k, f"{s.name} decode ops")
            r["main"] = False
            rec[kid].append(r)
        del seen
        torch.cuda.empty_cache()
        seen, _ = _capture(lambda: encode_stream_batched(
            s.packed, s.npx, colch=3, out_cap=s.out_cap, compat=True))
        for key, (a, k) in seen.items():
            kid, r = _check_qoi_call(key, a, k, f"{s.name} encode")
            rec[kid].append(r)
        del seen
        torch.cuda.empty_cache()
    return rec


# K5 and K8 at the edges of their tiling (4096 entries a tile): one entry,
# a ragged vector, one tile less one, one, one more, three and one, many
# short rows, rows that start off 16-byte boundaries, and a long unaligned
# row (the .qoi decode's op count)
EDGE_SHAPES = ((1, 1), (1, 3), (1, 4095), (1, 4096), (1, 4097),
               (1, 3 * 4096 + 1), (37, 4097), (4096, 37), (2, 11807483))


def _edge_inputs(gen, shape, combine, dev):
    """Random (B, M) int32 arrays for one K8 combine, as its callers make
    them (fill: 0/1 flags; segmod: pack_pair words; maps: state maps)."""
    import torch

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    if combine == "fill":
        return (ints(-2**31, 2**31), (ints(0, 1000) < 3).to(torch.int32))
    if combine == "segmod":
        return ((ints(0, 2**31) & 0x01FF01FF),)
    if combine == "maps":
        return (ints(0, 4) + ((0 << 3) | (1 << 6) | (2 << 9) | (3 << 12)),)
    return (ints(-2**31, 2**31),)


def _offset(x):
    """x's values in a tensor of the same shape whose storage starts one
    element (4 bytes for int32) past a 16-byte boundary."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def check_edge_kernels(dev):
    """K8 (every combine, fill with its two arrays), K5 (all-0, all-1,
    about 35% and last-entry-only masks, two payloads) and K11 (random op
    words of every kind, op totals from 0 to the row's length, with and
    without hashes, and its check) against their plain versions at
    EDGE_SHAPES, bit-exact, on inputs made on the card from a seed; all
    three also on inputs whose storage starts 4 bytes past a 16-byte
    boundary, and K11 on rows inside wider rows. Returns {kernel:
    [records]}."""
    import torch

    from seqoia_tpu_torch.ops import compact, fixpoint, scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rec = {"K5": [], "K8": [], "K11": []}
    for shape in EDGE_SHAPES:
        bsz, m = shape
        rec["K11"] += _edge_fixpoint(gen, shape, dev)
        for combine in scan.COMBINES:
            arrays = _edge_inputs(gen, shape, combine, dev)
            for where, xs in (("", arrays),
                              (" offset", tuple(_offset(a) for a in arrays))):
                if where and bsz * m > 1 << 20:
                    continue
                got = scan.tile_scan(xs, combine)
                want = scan.tile_scan_plain(xs, combine)
                rec["K8"].append(dict(
                    shape=f"edge {combine} {shape}{where}", main=False,
                    err=max(_max_err(g, w) for g, w in zip(got, want))))
        i32 = dict(dtype=torch.int32, device=dev)
        key = torch.arange(bsz * m, **i32).view(shape)
        pays = [_edge_inputs(gen, shape, "max", dev)[0] for _ in range(2)]
        last = torch.zeros(shape, dtype=torch.bool, device=dev)
        last[:, -1] = True
        masks = {"none": torch.zeros_like(last), "all": ~torch.zeros_like(last),
                 "35%": torch.rand(shape, generator=gen, device=dev) < 0.35,
                 "last": last}
        for name, valid in masks.items():
            for where, (k, ps) in (("", (key, pays)),
                                   (" offset", (_offset(key),
                                                [_offset(p) for p in pays]))):
                if where and (name != "35%" or bsz * m > 1 << 20):
                    continue
                keys, cp, tot = compact.compact(valid, k, ps)
                pk, pp, ptot = compact.compact_plain(valid, k, ps)
                err = max([_max_err(tot, ptot), _max_err(_live(keys, tot), pk)]
                          + [_max_err(_live(a, tot), b) for a, b in zip(cp, pp)])
                rec["K5"].append(dict(shape=f"edge {name} {shape}{where}",
                                      err=err, main=False))
        torch.cuda.empty_cache()
    return rec


def _edge_fixpoint(gen, shape, dev):
    """K11's records at one edge shape (see check_edge_kernels)."""
    import torch
    import torch.nn.functional as F

    from seqoia_tpu_torch.ops import fixpoint

    bsz, m = shape
    lo, hi, iv = (_edge_inputs(gen, shape, "max", dev)[0] for _ in range(3))
    hi = hi & 255
    tot = torch.randint(0, m + 1, (bsz,), generator=gen, device=dev,
                        dtype=torch.int64).to(torch.int32)
    tot[0] = m
    small = bsz * m <= 1 << 20
    cases = [("", (lo, hi, iv))]
    if small:
        cases += [(" offset", tuple(_offset(x) for x in (lo, hi, iv))),
                  (" in wider rows", tuple(F.pad(x, (0, 5))[:, :m]
                                           for x in (lo, hi, iv)))]
    out = []
    for where, (a, b, c) in cases:
        for with_h in (True, False):
            got = fixpoint.op_values(a, b, c, tot, hashes=with_h)
            want = fixpoint.op_values_plain(a, b, c, tot, with_h)
            err = _max_err(got[0], want[0])
            if with_h:
                err = max(err, _max_err(got[1], want[1]))
            out.append(dict(shape=f"edge values{'' if with_h else ' only'} "
                                  f"{shape}{where}", err=err, main=False))
    # the check: rows equal, and rows that differ in one entry
    other = iv.clone()
    flip = torch.randint(0, m, (bsz,), generator=gen, device=dev)
    rows = torch.arange(bsz, device=dev)
    other[rows[::2], flip[::2]] ^= 1
    for where, x in (("", other), (" equal", iv)):
        out.append(dict(shape=f"edge settled {shape}{where}", main=False,
                        err=_max_err(fixpoint.settled(x, iv),
                                     fixpoint.settled_plain(x, iv))))
    return out


def check_edge_slots(dev):
    """K7 against its plain version, bit-exact, at EDGE_SHAPES with 64 and
    128 slots: n_live at 0, 1, mid-tile and m; hashes all in one slot, all
    -1 (no writer) and uniform; queries dense (the encode's form: the
    hashes themselves) and sparse (about 0.5%, as in the decode); and on
    storage 4 bytes past a 16-byte boundary. The 11.8 M-entry shape only
    with uniform hashes (its plain version takes seconds). Returns
    [records]."""
    import torch

    from seqoia_tpu_torch.ops import slots

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    i32 = dict(dtype=torch.int32, device=dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    rows = []
    for shape in EDGE_SHAPES:
        bsz, m = shape
        big = bsz * m > 1 << 20
        values = ints(-2**31, 2**31, shape)
        for n_slots in (64, 128):
            hashes = {"uniform": torch.where(ints(0, 100, shape) < 90,
                                             ints(0, n_slots, shape), -1)}
            if not big:
                hashes["one slot"] = torch.full(shape, n_slots - 1, **i32)
                hashes["none"] = torch.full(shape, -1, **i32)
            lives = {"m": m, "mid-tile": min(m, 4096 + 1234) // 2 + 1}
            if not big:
                lives.update({"0": 0, "1": 1})
            for hname, h in hashes.items():
                sparse = torch.where(ints(0, 1000, shape) < 5,
                                     ints(0, n_slots, shape), -1)
                for qname, q in (("dense", h), ("sparse", sparse)):
                    if big and (n_slots, qname) == (128, "dense"):
                        continue
                    for lname, live in lives.items():
                        if big and lname != "m" and n_slots == 64:
                            continue
                        n_live = torch.full((bsz,), live, **i32)
                        args = (h, values, q, n_slots, -7, n_live)
                        got = slots.slot_last_writer(*args)
                        want = slots.slot_last_writer_plain(*args)
                        rows.append(dict(
                            shape=f"edge {shape} slots={n_slots} {hname} "
                                  f"{qname} n_live={lname}",
                            err=_max_err(got, want), main=False))
            if not big:  # inputs off 16-byte boundaries
                h, q = hashes["uniform"], sparse
                args = (_offset(h), _offset(values), _offset(q), n_slots, 3,
                        None)
                rows.append(dict(
                    shape=f"edge {shape} slots={n_slots} uniform offset",
                    err=_max_err(slots.slot_last_writer(*args),
                                 slots.slot_last_writer_plain(
                                     *args[:5], torch.full((bsz,), m, **i32))),
                    main=False))
        torch.cuda.empty_cache()
    return rows


def _edge_tokens(mode, m=3 * 4096 + 200):
    """Synthetic op bytes with tokens across the 4096-byte tile edges of
    K1: an RGBA op with its alpha modifier, an RGB op, a LUMA op, BIGRUNs
    and a modifier alone after an edge, between 1-byte runs
    (tests/test_torch_frontend.py builds the same stream)."""
    s = np.full(m, 0xC1, np.uint8)
    s[:15] = 0
    for edge, token in ((4096, [0xFF, 1, 2, 3, 200, 0x65]),
                        (2 * 4096, [0xFE, 9, 8, 7]),
                        (2 * 4096 + 100, [0x9A, 0x37]),
                        (3 * 4096, [0xFF, 5, 6, 7, 8, 0x7F])):
        at = edge - 3 if edge % 4096 == 0 else edge
        s[at: at + len(token)] = token
    s[4096 + 50: 4096 + 60] = 0xFD
    if mode == "mono":
        s[2 * 4096 - 1: 2 * 4096 + 2] = [0xFF, 40, 90]
    return s


def check_edge_front(stages, dev):
    """K1 (one row a scan) against its plain version, bit-exact, in its
    three modes, on the SQOA workloads' streams (alpha: the RGBA photo,
    noalpha: an RGB photo, mono: the gray+alpha scan): rows of 4095, 4096,
    4097 and 3 * 4096 + 1 bytes with the stream's end at the row's end and 8
    bytes before it, a stream padded far past its end, an n_max that cuts
    the last op, 37 short rows, and the synthetic stream with tokens across
    the tile edges; in mode noalpha also rows whose last op ends or is cut
    at a tile's or a thread's edge with an alpha-range byte where the
    reference peeks after it (corpus.end_peek_rows), their flags held to
    the rows' own. Returns [records]."""
    import torch

    from seqoia_tpu_torch.ops import frontend
    from seqoia_tpu_torch.utils import corpus

    rows = []
    for s in stages:
        stream = np.frombuffer(s.streams[0], np.uint8)
        cases = []
        for m in (4095, 4096, 4097, 3 * 4096 + 1):
            for end in (m - 8, m):
                cases.append((f"M={m} clen={end}", stream[None, :m], [end],
                              s.n_max))
        pad = np.zeros((1, 1 << 22), np.uint8)
        pad[0, :20000] = stream[:20000]
        cases.append(("padded far past clen", pad, [20000 - 8], s.n_max))
        cases.append(("n_max cuts the last op", stream[None, :100000],
                      [100000 - 8], None))
        short = np.zeros((37, 700), np.uint8)
        for r in range(37):
            short[r, : 300 + 10 * r] = stream[: 300 + 10 * r]
        cases.append(("37 short rows", short,
                      [300 + 10 * r - 8 for r in range(37)], s.n_max))
        edge = _edge_tokens(s.mode)
        cases.append(("tokens across tile edges", np.stack([edge, edge]),
                      [len(edge) - 8, 2 * 4096 + 1], 1 << 20))
        if s.mode == "noalpha":  # the alpha peek after the last op
            data, clen, hits = corpus.end_peek_rows(frontend.TILE)
            cases.append(("end peek at tile and thread edges", data,
                          list(clen), 1 << 16))
        for name, data, clen, n_max in cases:
            data = torch.from_numpy(np.array(data)).to(dev)
            clen = torch.tensor(clen, dtype=torch.int32, device=dev)
            if n_max is None:  # one pixel short of the last op's first
                keys, _, tot, _ = frontend.decode_front_plain(
                    data, clen, 1 << 30, s.mode)
                n_max = int(keys[0, int(tot[0]) - 1])
            got = frontend.decode_front_compact(data, clen, n_max, s.mode)
            want = frontend.decode_front_plain(data, clen, n_max, s.mode)
            err = max(_max_err(a, b) for a, b in zip(_front_view(got),
                                                     _front_view(want)))
            if name.startswith("end peek"):  # flagged where it should be
                err = max(err, _max_err(want[3].cpu(), torch.tensor(hits)))
            rows.append(dict(
                shape=f"edge {s.name} {s.mode} {name} {tuple(data.shape)}",
                err=err, main=False))
    return rows


def _edge_pixels(gen, shape, p_change, dev):
    """(B, M) packed pixels made on the card from a seed: a smooth walk
    (LUMA deltas, a few alpha steps) with 20% noise pixels, held in runs
    whose pixels change with probability p_change (0: one color a row)."""
    import torch

    def rnd(lo, hi, sh):
        return torch.randint(lo, hi, sh, generator=gen, device=dev)

    bsz, m = shape
    d = rnd(-3, 4, (bsz, m, 4))
    d[..., 3] *= (rnd(0, 10, (bsz, m)) == 0)
    lev = torch.where(rnd(0, 5, (bsz, m, 1)) == 0, rnd(0, 256, (bsz, m, 4)),
                      torch.cumsum(d, dim=1)) & 255
    px = (lev[..., 0] | (lev[..., 1] << 8) | (lev[..., 2] << 16)
          | (lev[..., 3] << 24))
    keep = torch.rand((bsz, m), generator=gen, device=dev) < p_change
    keep[:, 0] = True
    idx = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    px = torch.gather(px, 1, idx)
    return (((px + 2**31) % 2**32) - 2**31).to(torch.int32)


def check_edge_encode_front(dev):
    """K3 against its plain version, bit-exact, at EDGE_SHAPES: colch 1 and
    3, without carries and with them (init_prev and run_in from a seed,
    run_in 0, 1 and 511 among them), pixels that change often, rarely
    (BIGRUNs across tiles) and never, n_valid at M and varied by row (0,
    1, mid-tile); the smaller shapes also on storage 4 bytes past a
    16-byte boundary. Returns [records]."""
    import torch

    from seqoia_tpu_torch.ops import encode_front

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = []
    for shape in EDGE_SHAPES:
        bsz, m = shape
        big = bsz * m > 1 << 20
        for kind, p in (("often", 0.6), ("rarely", 0.0005), ("never", 0.0)):
            if big and kind != "often":
                continue
            px = _edge_pixels(gen, shape, p, dev)
            r = torch.arange(bsz, device=dev)
            nvs = {"M": torch.full((bsz,), m, **i32)}
            if not big:
                varied = torch.tensor([0, 1, m // 2 + 1, m], **i32)
                nvs["varied"] = varied[r % 4].clamp(max=m)
            for colch in (3, 1):
                x = px if colch == 3 else px & ~0x00FF00FF
                carries = {"": (None, None)}
                if not big or colch == 3:
                    run_in = torch.tensor([0, 1, 511], **i32)[r % 3]
                    carries[" carries"] = (
                        x[(r + 1) % bsz, -1].contiguous(), -(run_in + 1))
                for cname, (ip, l0) in carries.items():
                    for nname, nv in nvs.items():
                        for where in ("", " offset"):
                            if where and big:
                                continue
                            xs = _offset(x) if where else x
                            got = encode_front.encode_front_compact(
                                xs, nv, colch, ip, l0)
                            want = encode_front.encode_front_plain(
                                xs, nv, colch,
                                torch.full((bsz,), encode_front.INIT_PACKED,
                                           **i32) if ip is None else ip,
                                torch.full((bsz,), -1, **i32)
                                if l0 is None else l0)
                            rows.append(dict(
                                shape=f"edge {shape} {kind} colch={colch}"
                                      f"{cname} n_valid={nname}{where}",
                                err=max(_max_err(a, b) for a, b in zip(
                                    _encode_front_view(got),
                                    _encode_front_view(want))),
                                main=False))
        torch.cuda.empty_cache()
    return rows


def _engine_edge_cases():
    """K2 and K6 at the edges of their tiling (4096 slots a block): (name,
    [keys per row], n_out), keys strictly increasing, made from a seed."""
    t = 4096
    rng = np.random.default_rng(6)

    def srt(n, hi, lo=0):
        return np.sort(rng.choice(np.arange(lo, hi), n, replace=False))

    n3 = 3 * t
    return [
        ("an entry on a tile's first slot",
         [np.r_[0, 5, t, t + 1, srt(50, 2 * t, t + 2), 2 * t],
          np.array([t, 2 * t, 2 * t + 3])], n3),
        ("a tile with no entry", [np.array([0, 10, 2 * t + 100, 2 * t + 101]),
                                  np.array([3, t - 1])], n3),
        ("tiles of 4096 entries", [np.arange(2 * t),
                                   np.r_[np.arange(t), np.arange(t, n3, 2)]],
         n3),
        ("totals of 0", [np.zeros(0, np.int64), srt(300, n3)], n3),
        ("rows of different totals", [srt(n, n3) for n in (1, 40, 2000, 9000)],
         n3),
        ("n_out not a multiple of 4096", [srt(700, 2 * t + 62), srt(3, 2 * t)],
         2 * t + 12),
        ("rgb words across a tile edge",
         [np.r_[srt(30, t - 2), t - 2, t - 1, t, t + 2] for _ in range(3)],
         t + 4),
        ("37 short rows", [srt(int(rng.integers(0, 60)), 100)
                           for _ in range(37)], 100),
        ("one long row", [srt(3_000_000, 1 << 22)], 1 << 22),
    ]


def check_edge_engine(dev):
    """K2 (every epilogue) and K6 (one stream, and three with the keys)
    against their plain versions, bit-exact, at _engine_edge_cases: keys
    past each row's total are junk, payloads random, n_pixels and the
    encode scalars vary by row; once on fresh storage and once on storage 4
    bytes past a 16-byte boundary; each launch re-launched REPEATS times.
    Returns {"K2": [records], "K6": [records]}."""
    import torch

    from seqoia_tpu_torch.codec import decode_v2, encode_v2
    from seqoia_tpu_torch.ops import engine

    rng = np.random.default_rng(7)
    epilogues = [decode_v2._epilogue(3, 4), decode_v2._epilogue(3, 3),
                 decode_v2._epilogue(1, 1),
                 decode_v2._epilogue(1, 2), encode_v2._emit_epilogue(3),
                 encode_v2._emit_epilogue(1), encode_v2._compat_epilogue()]
    rec = {"K2": [], "K6": []}
    for name, ks, n_out in _engine_edge_cases():
        bsz, mc = len(ks), max(len(k) for k in ks) + 3
        keys = rng.integers(-5, n_out, (bsz, mc)).astype(np.int32)
        for r, k in enumerate(ks):
            keys[r, : len(k)] = k
        i32 = dict(dtype=torch.int32, device=dev)
        keys = torch.from_numpy(keys).to(dev)
        pays = [torch.from_numpy(rng.integers(-2**31, 2**31, (bsz, mc))
                                 .astype(np.int32)).to(dev) for _ in range(3)]
        tot = torch.tensor([len(k) for k in ks], **i32)
        rows = torch.arange(bsz, **i32)
        npx = (n_out - 7 * rows).clamp(min=0)[:, None]
        enc_scal = torch.stack([
            torch.tensor([n_out - 30, n_out + 5, 0, n_out // 2],
                         **i32)[rows % 4], rows % 2,
            ((rows + 1) % 3 != 0).to(torch.int32)], dim=-1)
        for where in ("", " offset"):
            if where:
                keys, pays = _offset(keys), [_offset(p) for p in pays]
            for n_pay, fk in ((1, False), (3, True)):
                inits = (-7, 3, 11)[:n_pay] + ((-1,) if fk else ())
                run = lambda: engine.place_fill(  # noqa: E731
                    keys, pays[:n_pay], tot, n_out, inits, fill_keys=fk)
                got = run()
                want = engine._fill_plain(
                    keys, pays[:n_pay] + ([keys] if fk else []), tot, n_out,
                    inits)
                rec["K6"].append(dict(
                    shape=f"edge {name} streams={len(got)} rows={bsz} "
                          f"n_out={n_out}{where}", main=False,
                    err=max(_max_err(g, w) for g, w in zip(got, want)),
                    repeats_differ=_repeats_differ(run, list, got)))
            for epi in epilogues:
                keyed = epi.kind in engine._KEYED
                n_pay = 2 if keyed else 1
                inits = (encode_v2._emit_inits() if keyed
                         else (decode_v2._INIT_PACKED,))
                scal = enc_scal if keyed else npx
                run = lambda: engine.place_emit(  # noqa: E731
                    keys, pays[:n_pay], tot, scal, n_out, inits, epi)
                got = run()
                err, _ = _plain_emit(got, keys, pays[:n_pay], tot, scal,
                                     n_out, inits, epi)
                rec["K2"].append(dict(
                    shape=f"edge {name} epilogue {_EPILOGUES[epi.kind]} "
                          f"rows={bsz} n_out={n_out}{where}", main=False,
                    err=err, repeats_differ=_repeats_differ(
                        run, lambda o: [o], got)))
        torch.cuda.empty_cache()
    return rec


def _fix_row(s, conv, rows, stats):
    """One .qoi workload's fixpoint record: its stats beside the probe's
    INDEX-chain depths (strict and predicted, the largest over its
    streams) and INDEX ops."""
    return dict(workload=s.name, converged=conv, rows=rows,
                passes=stats["passes"], settled_rows=stats["settled_rows"],
                settle_passes=stats["settle_passes"],
                sequential_rows=stats["sequential_rows"],
                strict_depth=max(p[4] for p in s.probe),
                predicted_depth=max(p[0] for p in s.probe),
                index_ops=sum(p[2] for p in s.probe))


def qoi_path(qstages, dev):
    """Encode and decode every .qoi workload through the public entry
    points, byte-exact against the native codec. Returns ([(phase, Mpx/s)],
    [fixpoint record per workload], [(rows, K2's cap, SQOA) per encode
    call])."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.codec import (decode_stream_compat_batched,
                                        encode_stream_batched)

    rates, fix, calls = [], [], []

    clock = functools.partial(_clock, rates)

    for s in qstages:
        if s.name == "batch_rgb_qoi":
            bsz = len(s.streams)
            out, total = clock(
                "batch .qoi encode (encode_stream_batched, compat)", bsz * s.n,
                lambda: encode_stream_batched(
                    torch.from_numpy(s.packed_host).to(dev), s.npx, colch=3,
                    compat=True))
            calls.append((bsz, s.out_cap, False))
            if out.shape[1] != s.out_cap:
                raise AssertionError(f"batch .qoi encode: K2 ran at "
                                     f"{out.shape[1]} bytes, not the checked "
                                     f"{s.out_cap}")
            out, total = out.cpu().numpy(), total.cpu().numpy()
            for i, stream in enumerate(s.streams):
                if out[i, : total[i]].tobytes() != stream[14:]:
                    raise AssertionError(f"batch .qoi encode row {i} differs")
            stats = {}
            pix, conv = clock(
                "batch .qoi decode (decode_stream_compat_batched)", bsz * s.n,
                lambda: decode_stream_compat_batched(
                    torch.from_numpy(s.buf_host).to(dev), s.clen, s.npx,
                    colch=3, out_ch=3, n_max=s.n_max, stats=stats))
            pix = pix.cpu().numpy()
            for i, stream in enumerate(s.streams):
                if not np.array_equal(pix[i, : s.n * 3], s.pixels[i]):
                    raise AssertionError(f"batch .qoi decode row {i} differs")
            fix.append(_fix_row(s, sum(conv.tolist()), bsz, stats))
            continue
        stream, pixels = s.streams[0], s.pixels[0]
        if s.name in ("index_chain", "value_chain"):
            # the batched call's flags and stats, then the public decode
            stats = {}
            px, conv = clock(
                f"{s.name} decode (decode_stream_compat_batched)", s.n,
                lambda: decode_stream_compat_batched(
                    s.data, s.clen, s.npx, colch=3, out_ch=4, n_max=s.n_max,
                    stats=stats))
            if conv.tolist() != [False] or stats["settled_rows"] != 1:
                raise AssertionError(f"{s.name}: the fixpoint settled it")
            if stats["sequential_rows"] != (s.name == "value_chain"):
                raise AssertionError(f"{s.name}: K9 decoded "
                                     f"{stats['sequential_rows']} rows")
            if not np.array_equal(px[0, : s.n * 4].cpu().numpy(), pixels):
                raise AssertionError(f"{s.name}: batched decode differs")
            fix.append(_fix_row(s, 0, 1, stats))
        else:
            fix.append(_fix_row(s, s.fix["converged"], 1, s.fix))
        enc = clock(f"{s.name} encode (seqoia_tpu_torch.encode)", s.n,
                    lambda: st.encode(pixels, s.desc, device=dev))
        calls.append((1, s.out_cap, False))
        if enc != stream:
            raise AssertionError(f"{s.name}: encode differs")
        got, desc = clock(f"{s.name} decode (seqoia_tpu_torch.decode)", s.n,
                          lambda: st.decode(stream, device=dev))
        if not np.array_equal(got, pixels) or desc.qoi_compat != 1:
            raise AssertionError(f"{s.name}: decode differs")
    return rates, fix, calls


def check_pack_kernel(large, dev):
    """K4 against its plain version on the raw bytes of each large image
    (strides 3, 1 and 2), padded as normalize_pixels_device pads them; the
    library call beside stride 3 is F.pad of the (N, 3) bytes with 255."""
    import torch
    import torch.nn.functional as F

    from seqoia_tpu_torch.ops import pack

    rows = []
    for name, pixels, w, h, ch in large:
        stride = ch
        n_pad = -(-w * h // pack.TILE) * pack.TILE
        raw = torch.zeros(n_pad * stride, dtype=torch.uint8)
        raw[: pixels.size] = torch.from_numpy(pixels)
        words = raw.to(dev).view(torch.int32)[None]
        got = pack.pack_words(words, stride)
        want, p_ms = _plain_ms(lambda: pack.pack_words_plain(words, stride))
        library = None
        if stride == 3:
            u8 = words.view(torch.uint8).view(n_pad, 3)
            lib = lambda: F.pad(u8, (0, 1), value=255)  # noqa: E731
            if not torch.equal(lib().view(torch.int32).view(1, n_pad), got):
                raise AssertionError("K4: the library call differs")
            library = _timed(lib)
        rows.append(dict(
            shape=f"{name} stride={stride} (1, {n_pad})",
            err=_max_err(got, want),
            ms=_timed(lambda: pack.pack_words(words, stride)), plain_ms=p_ms,
            bytes=(stride + 4) * n_pad, library_ms=library))
        del got, want, words
        torch.cuda.empty_cache()
    return rows


def _buckets(streams):
    """The streams of one icon class by power-of-two stream bucket, as
    BatchDecoder groups them; only the buckets that take its packed route
    (two or more streams of at most 8192 bytes)."""
    out = {}
    for s in streams:
        out.setdefault(_pow2(len(s)), []).append(s)
    return {seg: b for seg, b in out.items() if seg <= 8192 and len(b) > 1}


def check_segment_kernel(classes, dev):
    """K1 in segment mode against its plain version, on the packed rows
    BatchDecoder builds for the largest bucket of each icon class."""
    from seqoia_tpu_torch.ops import frontend
    from seqoia_tpu_torch.parallel import batch

    rows = []
    for (name, streams), mode in zip(classes.items(),
                                     ("alpha", "noalpha", "mono")):
        seg, bucket = max(_buckets(streams).items(), key=lambda kv: len(kv[1]))
        buf, slens = batch.pack_segments(bucket, seg)
        data, slens = buf.to(dev), slens.to(dev)
        n_max = (32768 // seg) * 4096
        kw = dict(mode=mode, seg=seg, seg_px=4096)

        def run():
            return frontend.decode_front_compact(data, slens, n_max, **kw)
        keys, pays, tot, ref = run()
        (pk, pp, ptot, pref), p_ms = _plain_ms(
            lambda: frontend.decode_front_plain_seg(data, slens, n_max, mode,
                                                    seg, 4096))
        err = max(_max_err(tot, ptot), _max_err(ref, pref),
                  _max_err(_live(keys, tot), pk),
                  _max_err(_live(pays, tot), pp))
        if int(ref.max()) != 0:
            raise AssertionError(f"{name}: a row flagged foreign")
        rows.append(dict(
            shape=f"{name} {tuple(data.shape)} {mode} seg={seg} "
                  f"images={len(bucket)}",
            err=err, ms=_timed(run), plain_ms=p_ms,
            bytes=sum(len(x) for x in bucket) + 4 * slens.numel()
            + 8 * int(tot.sum()) + 8 * len(tot),
            **_held(run, (keys, pays, tot, ref), _front_view)))
    return rows


def check_edge_segments(dev):
    """K1 in segment mode against its plain version, bit-exact, in its
    three modes at every seg from 128 to 32768: three packed rows of
    native streams (icons, and images half noise, half one color, long
    enough to cross the 4096-byte tiles where the segment allows), with
    empty segments, 72x64 images whose ops pass seg_px (cut there),
    streams of very different lengths side by side, and one segment whose
    length runs to its end; in mode noalpha at seg 128 and 8192 the rows
    of corpus.end_peek_segments, their flags held to the rows' own.
    Returns [records]."""
    import torch

    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import frontend
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(9)
    rows = []
    for ch, mode in ((4, "alpha"), (3, "noalpha"), (1, "mono")):
        pool = []
        for w in (64, 72):
            for _ in range(3):
                icon = corpus._icon(rng, w, 5)[:64]
                px = icon[..., :ch] if ch > 1 else icon[..., 1:2]
                pool.append(native.encode(np.ascontiguousarray(px).reshape(-1),
                                          w, 64, ch, 0, 0))
            half = np.full((64, w, ch), 77, np.uint8)
            pool.append(native.encode(half.reshape(-1), w, 64, ch, 0, 0))
            for n_rows in (4, 16, 64):  # stripes: short streams
                stripes = np.repeat(rng.integers(0, 256, (n_rows, 1, ch)),
                                    64 // n_rows, axis=0).repeat(w, axis=1)
                pool.append(native.encode(stripes.astype(np.uint8).reshape(-1),
                                          w, 64, ch, 0, 0))
            half[:32] = rng.integers(0, 256, (32, w, ch))
            pool.append(native.encode(half.reshape(-1), w, 64, ch, 0, 0))
        for seg in (128 << e for e in range(9)):
            fit = sorted((x for x in pool if len(x) <= seg), key=len)
            if not fit:
                continue
            k = max(8192, 4 * seg) // seg
            data = np.zeros((3, k * seg), np.uint8)
            slens = np.zeros((3, k), np.int32)
            for r in range(3):
                for j in range(k):
                    pick = rng.integers(-1, len(fit))  # -1: an empty segment
                    x = fit[-1] if j == r else (b"" if pick < 0 else fit[pick])
                    data[r, j * seg: j * seg + len(x)] = np.frombuffer(x,
                                                                     np.uint8)
                    slens[r, j] = max(len(x) - 8, 0)
            # a length past the stream: ops to the segment's very end, whose
            # operands past it read as 0
            slens[2, 1] = seg
            d = torch.from_numpy(data).to(dev)
            sl = torch.from_numpy(slens).to(dev)
            kw = dict(mode=mode, seg=seg, seg_px=4096)
            got = frontend.decode_front_compact(d, sl, k * 4096, **kw)
            want = frontend.decode_front_plain_seg(d, sl, k * 4096, mode,
                                                   seg, 4096)
            rows.append(dict(
                shape=f"edge {mode} seg={seg} {tuple(data.shape)}",
                err=max(_max_err(a, b) for a, b in zip(
                    _front_view(got), _front_view(want))), main=False,
                repeats_differ=_repeats_differ(
                    lambda: frontend.decode_front_compact(d, sl, k * 4096,
                                                          **kw),
                    _front_view, got, 5)))
    # mode noalpha: segments whose last op is followed by an alpha-range
    # byte where the reference peeks (the packed row flagged), and the same
    # row with only the segments that must not flag
    for seg in (128, 8192):
        data, slens, quiet = corpus.end_peek_segments(seg, frontend.TILE)
        k = data.shape[1] // seg
        d = torch.from_numpy(data).to(dev)
        for name, sl, flag in (("end peek", slens, 1), ("no end peek", quiet,
                                                         0)):
            sl = torch.from_numpy(sl).to(dev)
            got = frontend.decode_front_compact(d, sl, k * 4096, "noalpha",
                                                seg, 4096)
            want = frontend.decode_front_plain_seg(d, sl, k * 4096,
                                                   "noalpha", seg, 4096)
            rows.append(dict(
                shape=f"edge noalpha seg={seg} {name} {tuple(data.shape)}",
                err=max([_max_err(a, b) for a, b in zip(
                    _front_view(got), _front_view(want))]
                    + [abs(int(want[3][0]) - flag)]), main=False))
    return rows


# K2's epilogue selectors (seqoia_tpu_torch/ops/engine.py), by name
_EPILOGUES = ("fill", "decode 4ch", "decode 3ch", "decode mono 1ch",
              "decode mono 2ch", "encode color", "encode mono", "encode qoi",
              "decode gray to 4ch", "decode gray to 3ch",
              "decode colour to 1ch", "decode colour to 2ch")


def _plain_emit(out, keys, pays, tot, scal, n_out, inits, epi):
    """place_emit's output ``out`` against its plain version on the same
    arguments, evaluated slot range by slot range (a slot depends on no
    other, so an output of 10**8 slots fits). Returns (max err, plain ms)."""
    import torch

    from seqoia_tpu_torch.ops import engine

    streams = list(pays) + ([keys] if epi.kind in engine._KEYED else [])
    num, den = epi.units
    step = max((1 << 25) // keys.shape[0], 4096) // 4096 * 4096
    err, p_ms = 0, 0.0
    for lo in range(0, n_out, step):
        hi = min(lo + step, n_out)
        want, ms = _plain_ms(lambda: epi.plain(
            engine._fill_plain(keys, streams, tot, hi - lo, inits, lo),
            torch.arange(lo, hi, device=keys.device)[None, :], scal.long()))
        p_ms += ms
        err = max(err, _max_err(out[:, lo * num // den: hi * num // den],
                                want))
        del want
    return err, p_ms


def _live(rows, totals):
    """rows (B, M) with the entries at and past each row's total zeroed."""
    import torch

    idx = torch.arange(rows.shape[1], device=rows.device)[None, :]
    return torch.where(idx < totals[:, None], rows, 0)


def _checked(run, where, rec):
    """Run ``run()`` with the K1, K2, K3 and K4 wrappers replaced by ones
    that, at the first launch of each distinct shape and mode, hold the
    kernel's result against its plain version on the very arguments of that
    launch and append a record to rec[kernel]. A 134 Mpx row does not fit
    the plain versions in one piece: K1's walks the row in blocks (its own
    carry), K2's is evaluated slot range by slot range (a slot
    depends on no other); K3's takes the row whole. Launches made here
    count under the replacement, not under the wrappers' own counters."""
    import torch

    from seqoia_tpu_torch.ops import encode_front, engine, frontend, pack

    seen, saved = set(), []
    reps = 3

    def fresh(*sig):
        torch.cuda.empty_cache()
        return sig not in seen and not seen.add(sig)

    def k1(fn, data, clen, n_max, mode="alpha", seg=None, seg_px=None):
        out = fn(data, clen, n_max, mode, seg, seg_px)
        if not fresh("K1", tuple(data.shape), n_max, mode, seg):
            return out
        keys, pays, tot, ref = out
        if seg is None:
            plain = lambda: frontend.decode_front_plain(  # noqa: E731
                data, clen, n_max, mode)
        else:
            plain = lambda: frontend.decode_front_plain_seg(  # noqa: E731
                data, clen, n_max, mode, seg, seg_px)
        (pk, pp, ptot, pref), p_ms = _plain_ms(plain)
        err = max(_max_err(tot, ptot), _max_err(ref, pref),
                  _max_err(_live(keys, tot), pk),
                  _max_err(_live(pays, tot), pp))
        del pk, pp
        run = lambda: fn(data, clen, n_max, mode, seg, seg_px)  # noqa: E731
        r = dict(
            shape=f"{where} {tuple(data.shape)} {mode}"
                  + (f" seg={seg}" if seg else ""),
            err=err, plain_ms=p_ms, main=False, ms=_timed(run, reps),
            bytes=int(clen.sum()) + 4 * clen.numel() + 8 * int(tot.sum())
            + 8 * len(tot))
        # look-back kernels: the repeats must agree
        r.update(repeats_differ=_repeats_differ(run, _front_view, out),
                 cold_ms=_timed_cold(run, reps),
                 device_ms=_device_ms(run, reps))
        rec["K1" if seg is None else "K1seg"].append(r)
        return out

    def k2(fn, keys, pays, tot, scal, n_out, inits, epi):
        out = fn(keys, pays, tot, scal, n_out, inits, epi)
        if not fresh("K2", tuple(keys.shape), n_out, epi.kind):
            return out
        pays = list(pays)
        err, p_ms = _plain_emit(out, keys, pays, tot, scal, n_out, inits, epi)
        run = lambda: fn(keys, pays, tot, scal, n_out, inits,  # noqa: E731
                         epi)
        rec["K2"].append(dict(
            shape=f"{where} epilogue {_EPILOGUES[epi.kind]} "
                  f"rows={keys.shape[0]} n_out={n_out}",
            err=err, plain_ms=p_ms, main=False, ms=_timed(run, reps),
            bytes=4 * (1 + len(pays)) * int(tot.sum())
            + out.numel() * out.element_size(), **_held(run, out, reps=reps)))
        return out

    def k3(fn, packed, n_valid, colch=3, init_prev=None, lc0=None):
        out = fn(packed, n_valid, colch, init_prev, lc0)
        carried = init_prev is not None or lc0 is not None
        if not fresh("K3", tuple(packed.shape), colch, carried):
            return out
        bsz = packed.shape[0]
        i32 = dict(dtype=torch.int32, device=packed.device)
        ip = (torch.full((bsz,), encode_front.INIT_PACKED, **i32)
              if init_prev is None else init_prev)
        l0 = torch.full((bsz,), -1, **i32) if lc0 is None else lc0
        ek, (ec, em), et, ect, elc = out
        (pk, (pc, pm), pet, pct, plc), p_ms = _plain_ms(
            lambda: encode_front.encode_front_plain(packed, n_valid, colch,
                                                    ip, l0))
        err = max(_max_err(et, pet), _max_err(ect, pct), _max_err(elc, plc),
                  _max_err(_live(ek, et), pk), _max_err(_live(ec, et), pc),
                  _max_err(_live(em, et), pm))
        del pk, pc, pm
        run = lambda: fn(packed, n_valid, colch, init_prev, lc0)  # noqa: E731
        rec["K3"].append(dict(
            shape=f"{where} {tuple(packed.shape)} colch={colch}"
                  + (" carries" if carried else ""),
            err=err, plain_ms=p_ms, main=False, ms=_timed(run, reps),
            bytes=4 * packed.numel() + 12 * int(et.sum()) + 24 * bsz,
            **_held(run, out, _encode_front_view, reps)))
        return out

    def k4(fn, words, stride):
        out = fn(words, stride)
        if not fresh("K4", tuple(words.shape), stride):
            return out
        want, p_ms = _plain_ms(lambda: pack.pack_words_plain(words, stride))
        rec["K4"].append(dict(
            shape=f"{where} stride={stride} {tuple(words.shape)}",
            err=_max_err(out, want), plain_ms=p_ms, main=False,
            ms=_timed(lambda: fn(words, stride), reps),
            bytes=4 * words.numel() + 4 * out.numel()))
        return out

    for mod, name, check in ((frontend, "decode_front_compact", k1),
                             (engine, "place_emit", k2),
                             (encode_front, "encode_front_compact", k3),
                             (pack, "pack_words", k4)):
        fn = getattr(mod, name)
        rep = functools.partial(check, fn)
        saved.append((mod, name, fn))
        setattr(mod, name, rep)
    try:
        return run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_path_kernels(large, classes, mixed, pages, enc_sets, dev):
    """K1 (both modes of use), K2, K3 and K4 against their plain versions
    on the arguments the large-image, icon, page and batch-encode paths give
    them: every image of ``large`` through encode_large and decode_large,
    the RGB one through both shard forms as well (K3's carries, four rows),
    every icon class and the mixed list through BatchDecoder, the page
    loader's call (``pages``: K1 in mono mode, then K2's gray-to-RGB
    epilogue, as BatchDecoder decodes gray at channels=3) with each page's gray
    replicated to RGB and the call's launches and counters held, every list
    of ``enc_sets`` through BatchEncoder. Returns {kernel: [records]}."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.utils import trace

    rec = {k: [] for k in ("K1", "K1seg", "K2", "K3", "K4")}
    for name, pixels, w, h, ch in large:
        desc = st.SqoaDesc(w, h, ch)
        stream = _checked(lambda: st.encode_large(pixels, desc, device=dev),
                          f"{name} encode_large", rec)
        if stream != native.encode(pixels, w, h, ch, 0, 0):
            raise AssertionError(f"{name}: the checked encode_large differs")
        _checked(lambda: st.decode_large(stream, device=dev),
                 f"{name} decode_large", rec)
        if name == "large_rgb":
            _checked(lambda: st.encode_large_shardmap(pixels, desc, n_shards=4,
                                                      device=dev),
                     f"{name} encode_large_shardmap", rec)
            _checked(lambda: st.decode_large_shardmap(stream, n_shards=4,
                                                      device=dev),
                     f"{name} decode_large_shardmap", rec)
    dec = st.BatchDecoder(device=dev)
    for name, streams in list(classes.items()) + [("mixed", mixed)]:
        _checked(lambda: dec(streams), f"{name} BatchDecoder", rec)
    gray, streams = pages
    want = [np.repeat(p, 3).tobytes() for p in gray]
    out = _checked(lambda: dec(streams, 3), "pages BatchDecoder channels=3",
                   rec)
    before = trace.counters()
    for results in (out, dec(streams, 3)):
        if [(r.error, r.desc and r.desc.channels,
             r.pixels is not None and r.pixels.tobytes())
                for r in results] != [(None, 1, w) for w in want]:
            raise AssertionError("pages: BatchDecoder at channels=3 is not "
                                 "each page's gray replicated")
    moved = {k: trace.counters().get(k, 0) - before.get(k, 0) for k in (
        "kernels.launches.K1", "kernels.launches.K1.mono",
        "kernels.launches.K2", "kernels.launches.K2.conv",
        "kernels.launches.K6", "parallel.mono.images", "codec.emit.rows")}
    n = len(streams)
    if moved != {"kernels.launches.K1": 1, "kernels.launches.K1.mono": 1,
                 "kernels.launches.K2": 1, "kernels.launches.K2.conv": 1,
                 "kernels.launches.K6": 0, "parallel.mono.images": n,
                 "codec.emit.rows": n}:
        raise AssertionError(f"pages: one call moved {moved}")
    del out, want
    enc = st.BatchEncoder(device=dev)
    for name, px, descs, want in enc_sets:
        if _checked(lambda: enc(px, descs), f"{name} BatchEncoder",
                    rec) != want:
            raise AssertionError(f"{name}: the checked BatchEncoder differs")
    return rec


def _replaced_emit(filled, n_pixels, colch: int, out_ch: int, n_max: int):
    """The emission K2's conversion epilogues replaced, after K6's fill: the
    filled words widened to int64, four channel planes, their stack and a
    select, then the uint8 cast; flat (B, n_max * out_ch)."""
    import torch

    f = filled.long()
    r, g, b, a = f & 255, (f >> 8) & 255, (f >> 16) & 255, (f >> 24) & 255
    if colch == 3:
        cols = [r, g, b] if out_ch >= 3 else [g]
    else:
        cols = [r, r, r] if out_ch >= 3 else [r]
    if out_ch in (2, 4):
        cols.append(a)
    out = torch.stack(cols[:out_ch], dim=2)
    t = torch.arange(n_max, device=f.device)[None, :, None]
    out = torch.where(t < n_pixels.long()[:, None, None], out, 0)
    return out.to(torch.uint8).reshape(f.shape[0], n_max * out_ch)


def check_conversions(pages, dev):
    """K2's four conversion epilogues (gray to 4 and 3 channels, colour to 1
    and 2) against their plain forms and against the route they replaced
    (K6, then _replaced_emit), bit-exactly, each re-launched REPEATS times:
    at the page call's shape (K1 mono over ``pages``, the 128 pages of
    PAGES: (128, 262144) bytes, n_out 1,048,576) and at a Kodak-sized .qoi
    shape (the op values that decode_compat places for KODAK's 24 768x512
    photo-class .qoi streams, n_out 393,216). Each is timed beside its byte
    bound and the replaced route. Returns [K2 records]."""
    import torch

    from seqoia_tpu_torch import native, spec
    from seqoia_tpu_torch.codec import decode_compat, decode_v2
    from seqoia_tpu_torch.ops import engine, frontend
    from seqoia_tpu_torch.utils import corpus

    def staged(streams):
        buf = np.zeros((len(streams), _pow2(max(len(x) for x in streams))),
                       np.uint8)
        for i, x in enumerate(streams):
            buf[i, : len(x)] = np.frombuffer(x, np.uint8)
        clen = torch.tensor([len(x) - spec.PADDING_SIZE for x in streams],
                            dtype=torch.int32, device=dev)
        return torch.from_numpy(buf).to(dev), clen

    gray, streams = pages
    data, clen = staged(streams)
    npx = torch.tensor([g.size for g in gray], dtype=torch.int32,
                       device=dev)[:, None]
    n_max = _pow2(int(npx.max()))
    keys, pays, tot, _ = frontend.decode_front_compact(data, clen, n_max,
                                                       "mono")
    cases = [(f"pages {tuple(data.shape)}", keys, pays, tot, npx, n_max)]
    w, h, k = KODAK
    rng = np.random.default_rng(27)
    data, clen = staged([native.encode(corpus._photo(rng, w, h).reshape(-1),
                                       w, h, 3, 0, 1) for _ in range(k)])
    n = w * h
    seen, _ = _capture(lambda: decode_compat.decode_stream_compat_batched(
        data, clen, torch.full((k,), n, dtype=torch.int32, device=dev),
        colch=3, out_ch=3, n_max=n))
    (keys, (pays,), tot, npx, _, _, _), _ = seen["K2"]
    cases.append((f"Kodak-sized .qoi {tuple(data.shape)}", keys, pays, tot,
                  npx, n))
    del data, seen
    init = (decode_v2._INIT_PACKED,)
    rows = []
    for where, keys, pays, tot, npx, n_out in cases:
        for colch, out_ch in ((1, 4), (1, 3), (3, 1), (3, 2)):
            epi = decode_v2._epilogue(colch, out_ch)
            run = lambda: engine.place_emit(  # noqa: E731
                keys, [pays], tot, npx, n_out, init, epi)
            old = lambda: _replaced_emit(  # noqa: E731
                engine.place_fill(keys, [pays], tot, n_out, init)[0],
                npx[:, 0], colch, out_ch, n_out)
            got = run()
            err, p_ms = _plain_emit(got, keys, [pays], tot, npx, n_out,
                                    init, epi)
            was = old()
            if not torch.equal(got.view(torch.uint8), was):
                err = max(err, _max_err(got.view(torch.uint8), was), 1)
            del was
            rows.append(dict(
                shape=f"{where} epilogue {_EPILOGUES[epi.kind]} "
                      f"rows={keys.shape[0]} n_out={n_out}",
                err=err, plain_ms=p_ms, main=False, ms=_timed(run),
                replaced_ms=_timed(old),
                bytes=8 * int(tot.sum()) + got.numel() * got.element_size(),
                **_held(run, got)))
            del got
            torch.cuda.empty_cache()
    return rows


def check_saturation(dev):
    """K1 on a stream whose pixel counts pass 2**31 (8 MiB of BIGRUN ops):
    the kernel's pixel offsets saturate where its plain version's int64
    offsets go on, and both keep exactly the ops below n_max."""
    import torch

    from seqoia_tpu_torch.ops import frontend

    m, n_max = 1 << 23, 1 << 30
    data = torch.full((1, m), 0xFD, dtype=torch.uint8, device=dev)
    clen = torch.tensor([m - 8], dtype=torch.int32, device=dev)

    def run():
        return frontend.decode_front_compact(data, clen, n_max, "alpha")
    keys, pays, tot, ref = run()
    (pk, pp, ptot, pref), p_ms = _plain_ms(
        lambda: frontend.decode_front_plain(data, clen, n_max, "alpha"))
    if int(tot) != n_max // 512:
        raise AssertionError(f"K1 kept {int(tot)} BIGRUN ops below {n_max} "
                             f"pixels, not {n_max // 512}")
    return dict(
        shape=f"BIGRUN stream past 2**31 pixels {tuple(data.shape)} alpha",
        err=max(_max_err(tot, ptot), _max_err(ref, pref),
                _max_err(_live(keys, tot), pk), _max_err(_live(pays, tot), pp)),
        ms=_timed(run), plain_ms=p_ms, main=False,
        bytes=m + 8 * int(tot) + 16)


def large_path(large, dev):
    """encode_large, decode_large and (for the RGB image) both shard forms at
    4 shards, byte-exact against the native codec. Returns ([(phase,
    Mpx/s)], the RGB image's stream, [(rows, K2's cap or None: any, SQOA)
    per encode call])."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.codec import encode_v2

    rates, rgb_stream, calls = [], None, []
    clock = functools.partial(_clock, rates)
    for name, pixels, w, h, ch in large:
        n = w * h
        desc = st.SqoaDesc(w, h, ch)
        stream = native.encode(pixels, w, h, ch, 0, 0)
        oracle, _ = native.decode(stream, 0)
        if not np.array_equal(oracle, pixels):
            raise AssertionError(f"{name}: the native codec does not round-trip")
        del oracle
        enc = clock(f"{name} encode_large", n,
                    lambda: st.encode_large(pixels, desc, device=dev))
        calls.append((1, encode_v2.exact_cap(torch.tensor([len(stream) - 15])),
                      True))
        if enc != stream:
            raise AssertionError(f"{name}: encode_large differs")
        got, d = clock(f"{name} decode_large", n,
                       lambda: st.decode_large(stream, device=dev))
        if not np.array_equal(got, pixels) or d != desc:
            raise AssertionError(f"{name}: decode_large differs")
        if name != "large_rgb":
            continue
        rgb_stream = stream
        enc4 = clock(f"{name} encode_large_shardmap (4 shards)", n,
                     lambda: st.encode_large_shardmap(pixels, desc, n_shards=4,
                                                      device=dev))
        calls.append((4, None, True))
        if enc4 != enc:
            raise AssertionError(f"{name}: the sharded encode differs")
        got4, _ = clock(f"{name} decode_large_shardmap (4 shards)", n,
                        lambda: st.decode_large_shardmap(stream, n_shards=4,
                                                         device=dev))
        if not np.array_equal(got4, got):
            raise AssertionError(f"{name}: the sharded decode differs")
    return rates, rgb_stream, calls


def large_steps(image, stream, dev):
    """The steps of encode_large and decode_large on the 134 Mpx image, run
    one by one after the main path, each ended by a synchronize: where the
    time of those calls goes. Returns {step: ms}."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.codec import decode_v2, encode_v2
    from seqoia_tpu_torch.ops import pack
    from seqoia_tpu_torch.parallel import tiled
    from seqoia_tpu_torch.utils import transfer

    _, pixels, w, h, ch = image
    n, desc, steps = w * h, st.SqoaDesc(w, h, ch), {}

    def step(what, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[what] = (time.perf_counter() - t) * 1e3
        return out

    packed = step("encode: pad, pin, copy up, K4",
                  lambda: pack.normalize_pixels_device(pixels, desc, dev))
    out, total = step(
        "encode: K3 + K2 (K2 sized from K3's total)",
        lambda: encode_v2.encode_stream_flat(packed, n, colch=3))
    body = step("encode: copy down",
                lambda: transfer.fetch_flat(out, int(total)))
    step("encode: header + bytes", lambda: tiled._file_bytes(desc, body))
    del packed, out, body
    m_pad = -(-len(stream) // 32768) * 32768

    def stage():
        buf = torch.zeros(m_pad, dtype=torch.uint8, pin_memory=True)
        buf.numpy()[: len(stream)] = np.frombuffer(stream, np.uint8)
        return buf.to(dev, non_blocking=True)[None]

    def one(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    data = step("decode: pad, pin, copy up", stage)
    words, _ = step(
        "decode: K1 + K2",
        lambda: decode_v2.decode_stream_batched(
            data, one(len(stream) - 8), one(n), colch=3, out_ch=3, n_max=n,
            emit="words", src_alpha=False))
    px = step("decode: copy down", lambda: transfer.fetch_flat(words[0]))
    # decode_large returns the pinned view; what a copy inside it would cost
    step(f"decode: a pageable copy of the {px.nbytes} pinned bytes "
         "(left to the caller)", px.copy)
    return steps


def icon_path(classes, mixed, ref_stream, dev):
    """The icon classes and the mixed list through BatchDecoder, every image
    byte-exact against the native codec. Returns ([(phase, Mpx/s)],
    [(phase, last_timings, last_stats)])."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native

    rates, timings = [], []
    clock = functools.partial(_clock, rates)
    dec = st.BatchDecoder(device=dev)

    def check(name, streams, results):
        for i, (s, r) in enumerate(zip(streams, results)):
            want, _ = native.decode(s, 0)
            if want is None:
                if r.pixels is not None or not r.error:
                    raise AssertionError(f"{name}: image {i} has no error slot")
            elif r.pixels is None or not np.array_equal(r.pixels, want):
                raise AssertionError(f"{name}: image {i} differs")

    for name, streams in classes.items():
        res = clock(f"{name} BatchDecoder ({len(streams)} x 64x64)",
                    4096 * len(streams), lambda: dec(streams))
        check(name, streams, res)
        st_ = dec.last_stats
        # every stream bucket of the class with two or more icons is packed
        want_rows = sum(-(-len(b) // (32768 // seg))
                        for seg, b in _buckets(streams).items())
        if st_["packed_rows"] != want_rows or want_rows == 0:
            raise AssertionError(f"{name}: {st_['packed_rows']} packed rows, "
                                 f"not {want_rows}")
        if st_["host_rows"] or st_["oom_redispatch"]:
            raise AssertionError(f"{name}: rows left the card: {st_}")
        timings.append((name, dec.last_timings, st_))
    n_px = sum(
        int.from_bytes(s[4:8], "big") * int.from_bytes(s[8:12], "big")
        for s in mixed[:-1])
    res = clock(f"mixed BatchDecoder ({len(mixed)} streams)", n_px,
                lambda: dec(mixed))
    check("mixed", mixed, res)
    if res[-1].error != "invalid header":
        raise AssertionError("mixed: the bad header has no error slot")
    st_ = dec.last_stats
    # the images of the REF stream's packed row go to the host (the row is
    # flagged as a whole), and nothing else: the REF stream is the last of
    # its class (the 64x64 RGBA icons of its stream bucket)
    seg = _pow2(len(ref_stream))
    n = 1 + sum(_pow2(len(s)) == seg for s in mixed[:64])
    k = 32768 // seg
    want_host = n - (n - 1) // k * k if n > 1 else 1
    if st_["host_rows"] != want_host:
        raise AssertionError(f"mixed: {st_['host_rows']} rows on the host, "
                             f"not {want_host}")
    if st_["oom_redispatch"]:
        raise AssertionError(f"mixed: out of device memory: {st_}")
    if st_["packed_rows"] < 2:
        raise AssertionError(f"mixed: the icons were not packed: {st_}")
    timings.append(("mixed", dec.last_timings, st_))
    return rates, timings


def _encode_sets(stages, qstages, icon_px, seed: int = 4):
    """The batch-encode path's lists: (name, [pixels], [SqoaDesc], [wanted
    stream]) for the three icon classes, the 32 RGB photos, the RGBA photo
    with the gray+alpha scan, the photos as .qoi, and a mixed list (icons
    of two classes, two photos as SQOA and as .qoi, an image without
    pixels and an invalid desc, whose wanted stream is None). The wanted
    streams are the native encodes the other paths made of the same
    pixels."""
    import seqoia_tpu_torch as st

    D = st.SqoaDesc
    sets = [(name, px, [D(64, 64, ch)] * len(px), icon_px[1][name])
            for name, (px, ch) in icon_px[0].items()]
    by = {s.name: s for s in list(stages) + list(qstages)}

    def of(name, compat=0):
        s = by[name]
        return (list(s.pixels), [D(s.w, s.h, s.ch, 0, compat)] * len(s.pixels),
                list(s.streams))

    def joined(*names):
        parts = [of(n, int(n.endswith("_qoi"))) for n in names]
        return tuple(sum(p, []) for p in zip(*parts))

    sets.append(("batch_rgb",) + of("batch_rgb"))
    sets.append(("photo_rgba + gray_alpha",) + joined("photo_rgba",
                                                      "gray_alpha"))
    sets.append(("photos as .qoi",) + joined("photo_rgba_qoi",
                                             "batch_rgb_qoi"))
    rng = np.random.default_rng(seed)
    pick = rng.permutation(64)
    mixed = []
    for name, first in (("icons_rgba", 0), ("tiles_gray", 1)):
        _, px, ds, want = next(x for x in sets if x[0] == name)
        mixed += [(px[j], ds[j], want[j]) for j in pick[first::2]]
    for name in ("batch_rgb", "batch_rgb_qoi"):
        mixed += list(zip(*[x[:2] for x in of(name, int("qoi" in name))]))
    mixed += [(None, D(64, 64, 4), None),
              (sets[0][1][0], D(0, 64, 4), None)]
    order = rng.permutation(len(mixed))
    sets.append(("mixed",) + tuple([mixed[j][k] for j in order]
                                   for k in range(3)))
    return sets


def _encode_classes(descs, want):
    """BatchEncoder's classes of one call: [(rows, K2's exact cap, SQOA,
    stride)] from the descs and the wanted streams (the caps from their
    bodies: SQOA after its header and start byte, .qoi after its header)."""
    from seqoia_tpu_torch.codec.encode import pixel_bucket

    groups = {}
    for d, w in zip(descs, want):
        if w is None:
            continue
        key = (d.col_channels, d.has_alpha, bool(d.qoi_compat),
               max(pixel_bucket(d.n_pixels), 4))
        groups.setdefault(key, []).append(
            len(w) - (14 if d.qoi_compat else 15))
    return [(len(b), max(-(-max(b) // 4) * 4, 4), not key[2],
             key[0] + key[1]) for key, b in groups.items()]


def batch_encode_path(sets, dev):
    """Every list of ``sets`` through BatchEncoder, a cold call (the
    first) and a warm one; every stream byte-exact against the native
    codec. Returns ([(phase, Mpx/s)], [(phase, last_timings, last_stats)],
    [(rows, K2's cap, SQOA) per class and call], K4 launches due)."""
    import seqoia_tpu_torch as st

    rates, timings, calls = [], [], []
    k4 = 0
    clock = functools.partial(_clock, rates)
    for name, px, descs, want in sets:
        n_px = sum(d.n_pixels for d, w in zip(descs, want) if w is not None)
        classes = _encode_classes(descs, want)
        for form in ("cold", "warm"):
            enc = st.BatchEncoder(device=dev)
            got = clock(f"{name} BatchEncoder ({len(px)} images, {form})",
                        n_px, lambda: enc(px, descs))
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            if bad:
                raise AssertionError(f"{name} BatchEncoder ({form}): streams "
                                     f"{bad[:8]} differ")
            st_ = enc.last_stats
            if st_["oom_redispatch"] or st_["oom_errors"]:
                raise AssertionError(f"{name}: out of device memory: {st_}")
            timings.append((f"{name} ({form})", enc.last_timings, st_))
            calls += [c[:3] for c in classes]
            k4 += sum(c[3] != 4 for c in classes)
    return rates, timings, calls, k4


def _mono_streams(color, seed: int = 3):
    """The mono .qoi path's streams (``corpus.mono_qoi``: seeded random ops,
    decoder-only): one 4096x4096 gray+alpha stream, and a BatchDecoder
    list of 64 1024x1024 streams (32 gray, 32 gray+alpha) mixed with the
    streams ``color`` in a seeded order."""
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    big = corpus.mono_qoi(rng, 4096, 4096, 2)
    streams = [corpus.mono_qoi(rng, 1024, 1024, 1 + i % 2) for i in range(64)]
    streams += list(color)
    return big, [streams[j] for j in rng.permutation(len(streams))]


def _mono_inputs(qstages):
    """_mono_streams with the 32 batch photos as .qoi, each stream as
    (stream, native.decode's pixels)."""
    from seqoia_tpu_torch import native

    big, streams = _mono_streams(
        next(s for s in qstages if s.name == "batch_rgb_qoi").streams)
    return ((big, native.decode(big, 0)[0]),
            [(x, native.decode(x, 0)[0]) for x in streams])


def _mono_stream(ops, n, ch=2):
    """A mono .qoi stream of one row of n pixels holding ``ops``' bytes."""
    return (b"qoif" + n.to_bytes(4, "big") + (1).to_bytes(4, "big")
            + bytes([ch, 0]) + bytes(ops) + bytes(7) + b"\x01")


def _mono_edge_streams():
    """K9 mono's edge rows as mono .qoi streams: no op, one op, RGBA ops
    writing each of the 128 slots (gray at alpha 7) and an INDEX read of
    every slot, runs to the row's end, and a run past it."""
    fill, seen = [], set()
    for g in range(256):
        k = (g * 5 + 7 * 11) % 128
        if k not in seen:
            seen.add(k)
            fill += [0xFF, g, 7]
    reads = [int(k) for k in np.random.default_rng(5).permutation(128)]
    return [_mono_stream([], 5), _mono_stream([0xFF, 200, 17], 3),
            _mono_stream(fill + reads, 256),
            _mono_stream([0xFE, 9, 0x85, 0xFD, 0xC0 + 40], 105),
            _mono_stream([0xFE, 9, 0xFD], 4, ch=1)]


def _mono_ops(streams, dev):
    """The mono route's K9 arguments for ``streams``: the tokenizer and K5
    (``decode_compat._ops``) on the card. Returns (lo, totals)."""
    import torch

    from seqoia_tpu_torch.codec import decode_compat

    m = _pow2(max(len(x) for x in streams))
    buf = np.zeros((len(streams), m), np.uint8)
    for i, x in enumerate(streams):
        buf[i, : len(x)] = np.frombuffer(x, np.uint8)
    clen = torch.tensor([len(x) - 8 for x in streams], dtype=torch.int32,
                        device=dev)
    lo, _, tot = decode_compat._ops(torch.from_numpy(buf).to(dev), clen,
                                    colch=1)
    return lo, tot


def _k9_mono_want(lo, tot):
    """Each op's value (gray | alpha << 24) as the native decoder gives it:
    each row's ops written back out as a mono .qoi stream of one row of
    pixels, decoded by ``native.decode`` and read at each op's first
    pixel. Returns (B, mo) int32, 0 past a row's total."""
    import torch

    from seqoia_tpu_torch import native

    lo_h, tot_h = lo.cpu().numpy(), tot.cpu().numpy()
    want = np.zeros(lo_h.shape, np.uint32)
    for r in range(lo_h.shape[0]):
        if tot_h[r] == 0:  # no op, no value
            continue
        w = lo_h[r, : tot_h[r]].view(np.uint32).astype(np.int64)
        tag = w & 255
        lens = np.where(tag == 0xFE, 2, np.where(tag == 0xFF, 3, 1))
        off = np.cumsum(lens) - lens
        body = np.zeros(int(lens.sum()), np.uint8)
        for k in range(3):
            at = lens > k
            body[off[at] + k] = (w[at] >> (8 * k)) & 255
        npix = np.where((tag >= 0xC0) & (tag < 0xFE), (tag & 63) + 1, 1)
        if len(body) and body[0] == 0x31:
            raise AssertionError("a row starts with the SQOA start byte")
        px, _ = native.decode(_mono_stream(body, int(npix.sum())), 2)
        px = px.reshape(-1, 2).astype(np.uint32)
        at = np.cumsum(npix) - npix
        want[r, : tot_h[r]] = px[at, 0] | (px[at, 1] << 24)
    return torch.from_numpy(want.view(np.int32)).to(lo.device)


#: the longest row K9's plain version walks beside a recorded launch (one
#: step an op, about 0.14 ms on the host at 32 rows): the BatchDecoder list's
#: 1024x1024 mono classes, not the 4096x4096 stream
_K9_PLAIN_OPS = 400_000


def _k9_edge_totals(m: int):
    """Row totals at the edges of K9's chunks and of its ring of chunks,
    and at a row's width m (and past it)."""
    from seqoia_tpu_torch.ops.sequential import CHUNK as c, RING

    edges = {0, 1, 2, 3 * c + 2, m - 1, m, m + 3}
    edges |= {k * c + d for k in range(1, 2 * RING + 2) for d in (-1, 0, 1)}
    return sorted(e for e in edges if e <= m + 3)


def _k9_held(where, lo, hi, tot, colch, main, want=None):
    """One K9 launch (the wrapper, colch 3 or 1) held to its plain version,
    which walks host copies of the same tensors (rows longer than
    _K9_PLAIN_OPS only to ``want``), and to ``want`` where given; timed and
    re-launched REPEATS times."""
    from seqoia_tpu_torch.ops import sequential

    def run():
        return sequential.sequential_decode(lo, hi, tot, colch)
    got = run()
    err = 0 if want is None else _max_err(got, want)
    longest = min(int(tot.max()), lo.shape[1])
    p_ms = None
    if longest <= _K9_PLAIN_OPS:
        host = [None if x is None else x.cpu() for x in (lo, hi, tot)]
        # one op a step: a full-size walk is timed without a warm-up
        plain, p_ms = _plain_ms(lambda: sequential.sequential_decode_plain(
            *host, colch), warm=not main)
        err = max(err, _max_err(got.cpu(), plain))
        del plain
    n_ops = int(tot.clamp(max=lo.shape[1]).sum())
    r = dict(shape=f"{where} {tuple(lo.shape)} ops={n_ops} longest={longest}",
             err=err, ms=_timed(run, 3 if main else REPS), plain_ms=p_ms,
             plain_on="host", bytes=(8 if colch == 1 else 12) * n_ops
             + 4 * len(tot),
             repeats_differ=_repeats_differ(run, lambda o: [o], got),
             longest=longest, main=main)
    del got
    return r


def _k9_edge_rows(lo, hi):
    """Row 0 of (lo, hi) repeated once for each of _k9_edge_totals:
    (lo, hi, totals)."""
    import torch

    m = lo.shape[1]
    tot = _k9_edge_totals(m)
    rep = [None if x is None else x[:1].expand(len(tot), m).contiguous()
           for x in (lo, hi)]
    return rep + [torch.tensor(tot, dtype=torch.int32, device=lo.device)]


def check_mono_k9(big, mixed, dev):
    """K9's mono step at the full-size launches of the mono path (the
    4096x4096 stream's decode and the BatchDecoder list's two mono classes,
    recorded): against native.decode's pixels at every op, and the
    BatchDecoder classes also against its plain version on host copies
    (which walks one op a step, too slow for the 4096x4096 row's 3M ops).
    Off the path, against its plain version (and native.decode where the
    rows are whole streams): edge rows, 64 short rows, 2048 rows of 64x64
    streams (the grid's row mapping) and one row repeated at totals on
    K9's chunk and ring edges. Each re-launched REPEATS times. Returns
    [records], the main-path ones first, those held to the plain version
    leading."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.ops import sequential
    from seqoia_tpu_torch.utils import corpus

    launches = []
    fn = sequential.sequential_decode

    def rec(lo, hi, tot, colch=3):
        if colch == 1:
            launches.append((lo, tot))
        return fn(lo, hi, tot, colch)

    sequential.sequential_decode = rec
    try:
        st.decode(big[0], device=dev)
        st.BatchDecoder(device=dev)([x for x, _ in mixed])
    finally:
        sequential.sequential_decode = fn
    if not launches:
        raise AssertionError("the mono path launched no K9 mono")

    rng = np.random.default_rng(7)
    short = [corpus.mono_qoi(rng, 128, 128, 1 + i % 2) for i in range(64)]
    many = [corpus.mono_qoi(rng, 64, 64, 1 + i % 2) for i in range(2048)]
    rows = []
    for where, lo, tot, main in (
            [("full-size",) + x + (True,) for x in launches]
            + [(w,) + _mono_ops(x, dev) + (False,) for w, x in (
                ("short rows", short), ("2048 rows", many),
                ("edge rows", _mono_edge_streams()))]):
        rows.append(_k9_held(where, lo, None, tot, 1, main,
                             want=_k9_mono_want(lo, tot)))
    lo, _ = _mono_ops([short[0]], dev)
    lo, _, tot = _k9_edge_rows(lo, None)
    rows.append(_k9_held("chunk-edge totals", lo, None, tot, 1, False))
    torch.cuda.empty_cache()
    if not any(r["main"] and r["plain_ms"] is not None for r in rows):
        raise AssertionError("no K9 mono launch of the mono path was held "
                             "to its plain version")
    rows.sort(key=lambda r: (not r["main"], r["plain_ms"] is None))
    return rows


def smem_load_ns(dev):
    """(ns, SM cycles) of one dependent shared-memory load: one thread
    chasing 2**22 links through a 128-entry shared table (k9_smem_chase),
    timed by CUDA events and by the SM clock."""
    import torch

    from seqoia_tpu_torch.ops import _build

    n = 1 << 22
    lib = _build.load("sequential")
    end = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)

    def run():
        _build.launch(lib, "k9_smem_chase", dev, n, _build.ptr(end),
                      _build.ptr(cycles))
    ms = _timed(run, 3)
    return ms * 1e6 / n, int(cycles.item()) / n


def ldg_load_ns(dev):
    """{region: (ns, SM cycles)} of one dependent __ldg byte read and the
    two integer ops that make the next address from it, in one thread
    (k10_ldg_chase): 2**20 links within a 4 KB region (L1-resident) and
    2**18 links spread over 64 MB of random bytes (past the 50 MB L2: L2 and
    HBM), timed by CUDA events and by the SM clock: what a walk that reads
    the stream from global memory pays a byte (K10 reads shared memory)."""
    import torch

    from seqoia_tpu_torch.ops import _build

    lib = _build.load("ref")
    gen = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8, device=dev,
                        generator=gen)
    end = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {}
    for region, mask, shift, stride, n in (
            ("4 KB", 4095, 0, 1, 1 << 20),
            ("64 MB", (64 << 20) - 1, 12, 4097, 1 << 18)):
        def run():
            _build.launch(lib, "k10_ldg_chase", dev, _build.ptr(buf), mask,
                          shift, stride, n, _build.ptr(end),
                          _build.ptr(cycles))
        ms = _timed(run, 3)
        out[region] = (ms * 1e6 / n, int(cycles.item()) / n)
    return out


def mono_qoi_path(big, mixed, dev):
    """The 4096x4096 mono .qoi stream through seqoia_tpu_torch.decode, and
    the mono + color .qoi list through BatchDecoder; every pixel equal to
    native.decode's and no row on the host. Returns ([(phase, Mpx/s)],
    [(phase, last_timings, last_stats)])."""
    import seqoia_tpu_torch as st

    rates = []
    clock = functools.partial(_clock, rates)
    stream, want = big
    got, desc = clock("mono .qoi 4096x4096 decode (seqoia_tpu_torch.decode)",
                      4096 * 4096, lambda: st.decode(stream, device=dev))
    if not np.array_equal(got, want) or desc.channels != 2:
        raise AssertionError("mono .qoi 4096x4096: decode differs")
    dec = st.BatchDecoder(device=dev)
    res = clock(f"mono + color .qoi BatchDecoder ({len(mixed)} x 1024x1024)",
                len(mixed) * 1024 * 1024,
                lambda: dec([x for x, _ in mixed]))
    for i, (r, (_, w)) in enumerate(zip(res, mixed)):
        if r.pixels is None or not np.array_equal(r.pixels, w):
            raise AssertionError(f"mono + color .qoi: stream {i} differs")
    if dec.last_stats["host_rows"] or dec.last_stats["oom_redispatch"]:
        raise AssertionError(f"mono + color .qoi left the card: "
                             f"{dec.last_stats}")
    return rates, [("mono + color .qoi", dec.last_timings, dec.last_stats)]


# --- the REF path (K10) and the tooling path ------------------------------

def _ref_inputs(stages, seed: int = 8):
    """K10's inputs: (small streams [(where, stream)], full-size [(name,
    stream, native pixels)]). Small: the hand-made and injected streams
    (utils/corpus.ref_hand_made, ref_injected), 64 64x64 streams of the
    REF maker (gray scans, gray+alpha, RGBA and RGB icons;
    utils/corpus.ref_sqoa) and the edge streams of K10's chunks at the
    kernel's own chunk size (utils/corpus.ref_edge_streams: windows across
    a chunk edge, teleports onto and past it, an alpha-modifier peek at a
    window's end, nested REFs, a ladder that walks the cursor back, the
    last pixel inside a run, dense random REFs). Full size: the maker on
    the SQOA path's 2048x2048 gray+alpha stream and its 4096x4096 RGBA
    photo."""
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import ref
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(seed)
    small = ([("hand-made", s) for s in corpus.ref_hand_made().values()]
             + [("injected", s) for s in corpus.ref_injected()])
    for i in range(64):
        kind = i % 4
        if kind < 2:
            img = corpus._mono_doc(rng, 64, 64)[..., :1]
            if kind == 1:
                a = np.full((64, 64, 1), 255, np.uint8)
                a[rng.random((64, 64)) < 0.05] = 200
                img = np.concatenate([img, a], -1)
        else:
            img = corpus._icon(rng, 64, 5, glow_w=0.6, glow_peak=0.5)
            if kind == 3:
                img = np.ascontiguousarray(img[..., :3])
        made = corpus.ref_sqoa(native.encode(img.reshape(-1), 64, 64,
                                             img.shape[2], 0, 0), rng)
        if made is None:
            raise AssertionError(f"the REF maker found no site in image {i}")
        small.append(("maker 64x64", made))
    small += [(f"edge (chunk {ref.CHUNK})", s)
              for s in corpus.ref_edge_streams(ref.CHUNK).values()]
    by_name = {s.name: s for s in stages}
    big = []
    for name in ("gray_alpha", "photo_rgba"):
        made = corpus.ref_sqoa(by_name[name].streams[0], rng)
        if made is None:
            raise AssertionError(f"the REF maker found no site in {name}")
        big.append((f"{name}_ref", made, native.decode(made, 0)[0]))
    return small, big


def _ref_args(stream, channels, dev):
    """K10's arguments as decode gives them: (the stream's padded buffer
    on dev, chunks_len, n_pixels, colch, out_ch, n_max)."""
    import torch

    from seqoia_tpu_torch import spec

    desc = spec.unpack_header(stream[:15] + bytes(8))
    buf = np.zeros(_pow2(len(stream)), np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)
    n = desc.n_pixels
    return (torch.from_numpy(buf).to(dev), len(stream) - 8, n,
            desc.col_channels,
            channels or desc.col_channels + desc.has_alpha, _pow2(max(n, 4)))


def check_ref_k10(small, big, dev):
    """K10 against its plain version on the card: at every small stream
    and channels 0-4 and at both full-size streams (outputs, err and the ops
    walked, bitwise); at the full-size streams also against native.decode's
    pixels, at their own channels and at 1-4. Every launch re-launched
    REPEATS times. Returns [records], the full-size ones first."""
    import torch

    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import ref

    rows = []
    for where, stream, want in big:
        data, clen, n, colch, out_ch, n_max = _ref_args(stream, 0, dev)

        def run():
            return ref.ref_decode(data, clen, n, colch=colch, out_ch=out_ch,
                                  n_max=n_max)
        got, gerr, gops = run()
        host = data.cpu()
        (pout, perr, pops), p_ms = _plain_ms(lambda: ref.ref_decode_plain(
            host, clen, n, colch=colch, out_ch=out_ch, n_max=n_max),
            warm=False)
        err = max(_max_err(got[: n * out_ch].cpu(), torch.from_numpy(want)),
                  _max_err(got.cpu(), pout), int(bool(gerr)), int(bool(perr)),
                  abs(int(gops) - int(pops)))
        rows.append(dict(
            shape=f"{where} m={data.numel()} n_pixels={n} colch={colch} "
                  f"out_ch={out_ch}",
            err=err, ms=_timed(run, 3), plain_ms=p_ms, plain_on="host",
            bytes=clen + n * out_ch, ops=int(gops), main=True,
            repeats_differ=_repeats_differ(run, list, (got, gerr, gops))))
        del got, pout
        # the same walk at each number of channels: 1-4 stores a pixel
        by_ch = rows[-1]["ms_by_out_ch"] = {}
        for c in range(1, 5):
            def run_c():
                return ref.ref_decode(data, clen, n, colch=colch, out_ch=c,
                                      n_max=n_max)
            got = run_c()[0]
            if not np.array_equal(got[: n * c].cpu().numpy(),
                                  native.decode(stream, c)[0]):
                raise AssertionError(f"K10 at {where} out_ch={c} differs "
                                     "from native.decode")
            by_ch[c] = _timed(run_c, 2)
        print(f"K10 {where}: ms at out_ch 1-4 "
              + ", ".join(f"{c}: {ms:.3f}" for c, ms in by_ch.items())
              + f" ({rows[-1]['ops']} ops, {n} pixels)")
    groups = {}
    for where, stream in small:
        for channels in range(5):
            data, clen, n, colch, out_ch, n_max = _ref_args(stream, channels,
                                                            dev)

            def run():
                return ref.ref_decode(data, clen, n, colch=colch,
                                      out_ch=out_ch, n_max=n_max)
            got = run()
            (pout, perr, pops), p_ms = _plain_ms(lambda: ref.ref_decode_plain(
                data.cpu(), clen, n, colch=colch, out_ch=out_ch,
                n_max=n_max), warm=False)
            g = groups.setdefault(where, dict(
                launches=0, err=0, ms=0.0, plain_ms=0.0, bytes=0, ops=0,
                repeats_differ=0))
            g["launches"] += 1
            g["err"] = max(g["err"], _max_err(got[0].cpu(), pout),
                           int(bool(got[1]) != bool(perr)),
                           abs(int(got[2]) - int(pops)))
            g["ms"] += _timed(run, 3)
            g["plain_ms"] += p_ms
            g["bytes"] += clen + n * out_ch
            g["ops"] += int(got[2])
            g["repeats_differ"] += _repeats_differ(run, list, got)
    for where, g in groups.items():
        rows.append(dict(shape=f"{where} x{g.pop('launches')} (summed)",
                         main=False, **g))
    return rows


def ref_path(big, dev):
    """The two full-size REF streams through seqoia_tpu_torch.decode with
    SEQOIA_REF_CUDA=1 (K1 flags them, K10 decodes them on the card), each
    at its own channels and at 4 forced; every pixel equal to
    native.decode's, which is timed beside it (the route taken with the
    variable unset). Returns [(phase, Mpx/s)]."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native

    rates = []
    old = os.environ.get("SEQOIA_REF_CUDA")
    os.environ["SEQOIA_REF_CUDA"] = "1"
    try:
        for name, stream, _ in big:
            desc = st.spec.unpack_header(stream[:15] + bytes(8))
            for channels in (0, 4):
                got, _ = _clock(rates, f"{name} decode channels={channels} "
                                f"(seqoia_tpu_torch.decode, "
                                f"SEQOIA_REF_CUDA=1)", desc.n_pixels,
                                lambda: st.decode(stream, channels,
                                                  device=dev))
                want, _ = _clock(rates, f"{name} decode channels={channels} "
                                 f"(native.decode, on the host)",
                                 desc.n_pixels,
                                 lambda: native.decode(stream, channels))
                if got is None or not np.array_equal(got, want):
                    raise AssertionError(f"{name} channels={channels}: the "
                                         "REF decode differs")
    finally:
        if old is None:
            del os.environ["SEQOIA_REF_CUDA"]
        else:
            os.environ["SEQOIA_REF_CUDA"] = old
    return rates


def _cli(*argv):
    """seqoia_tpu_torch.cli.main(argv) with its output captured: (exit
    code, what it printed)."""
    import contextlib
    import io

    from seqoia_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = cli.main(list(argv))
    return rc, out.getvalue()


def _bench(corpus_dir, dev):
    """`bench --cuda` over corpus_dir, 3 runs: its table as printed."""
    rc, table = _cli("bench", "--cuda", "--device", str(dev), corpus_dir, "3")
    if rc != 0 or "sqoa:cuda" not in table:
        raise AssertionError("cli bench --cuda failed")
    return table


def _bench_spread(tables):
    """{codec: [(least, most) of decode Mpx/s, of encode Mpx/s]} over the
    grand totals of several `bench` tables."""
    seen = {}
    for table in tables:
        for line in table.split("# Grand total", 1)[1].splitlines()[2:]:
            f = line.split()
            if len(f) == 7:
                seen.setdefault(f[0], []).append((float(f[3]), float(f[4])))
    return {c: [(min(v), max(v)) for v in zip(*runs)]
            for c, runs in seen.items()}


def tool_path(tmp, dev):
    """The tooling layer through seqoia_tpu_torch.cli.main on the card, in
    the directory tmp: `corpus` at scale 1 (31 PNGs, numpy writer where PIL
    is absent); `convert` of every PNG to .sqoa and .qoi and back, each
    file and exit code equal to `convert --native`'s (the encoder refuses
    mono .qoi, so the gray scans fail alike); `bench --cuda` over the
    directory, 3 runs; `fuzz --cuda` at 1000 iterations, unset and with
    SEQOIA_REF_CUDA=1. Returns (the corpus directory, {phase: seconds},
    K10 launches of the fuzz with SEQOIA_REF_CUDA=1)."""
    from seqoia_tpu_torch.utils import trace

    secs, on = {}, ["--device", str(dev)]
    corpus_dir = os.path.join(tmp, "corpus")
    t = time.perf_counter()
    if _cli("corpus", corpus_dir)[0] != 0:
        raise AssertionError("cli corpus failed")
    pngs = sorted(f for f in os.listdir(corpus_dir) if f.endswith(".png"))
    if len(pngs) != 31:
        raise AssertionError(f"cli corpus wrote {len(pngs)} PNGs, not 31")
    secs["corpus"] = time.perf_counter() - t
    t, refused = time.perf_counter(), 0
    for f in pngs:
        src = os.path.join(corpus_dir, f)
        for ext in (".sqoa", ".qoi"):
            files, rcs = [], []
            for tag, how in (("native", ["--native"]), ("card", on)):
                out = os.path.join(tmp, f"{tag}{ext}")
                back = out + ".png"
                rc = _cli("convert", *how, src, out)[0]
                rcs.append(rc)
                if rc == 0:
                    rcs.append(_cli("convert", *how, out, back)[0])
                    files.append([open(p, "rb").read() for p in (out, back)])
            if len(set(rcs)) != 1 or len(files) not in (0, 2) \
                    or files and files[0] != files[1]:
                raise AssertionError(f"cli convert {f} to {ext}: the card "
                                     f"and --native differ ({rcs})")
            refused += rcs[0] != 0
    if refused != 2:  # the two gray scans as .qoi
        raise AssertionError(f"cli convert refused {refused} files")
    secs["convert"] = time.perf_counter() - t
    t = time.perf_counter()
    _bench(corpus_dir, dev)
    secs["bench"] = time.perf_counter() - t
    t = time.perf_counter()
    fuzz = {}
    for ref_cuda in ("", "1"):
        old = os.environ.get("SEQOIA_REF_CUDA")
        os.environ["SEQOIA_REF_CUDA"] = ref_cuda
        n0 = trace.counters().get("kernels.launches.K10", 0)
        try:
            rc, out = _cli("fuzz", "1000", "--cuda", *on)
        finally:
            if old is None:
                del os.environ["SEQOIA_REF_CUDA"]
            else:
                os.environ["SEQOIA_REF_CUDA"] = old
        if rc != 0:
            raise AssertionError(f"cli fuzz --cuda (SEQOIA_REF_CUDA="
                                 f"{ref_cuda!r}): {out.strip()}")
        fuzz[ref_cuda] = (trace.counters().get("kernels.launches.K10", 0)
                          - n0)
        print(f"fuzz --cuda, SEQOIA_REF_CUDA={ref_cuda!r}: {out.strip()}; "
              f"{fuzz[ref_cuda]} decodes reached K10")
    if fuzz[""] or not fuzz["1"]:
        raise AssertionError(f"K10 launches in the fuzz runs: {fuzz}")
    secs["fuzz"] = time.perf_counter() - t
    return corpus_dir, secs, fuzz["1"]


# --- the mesh path and the .qoi batch policy --------------------------------

def _sync_all():
    """Wait for every card (a mesh call may run on several)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _qoi_icons(icon_px):
    """The color icon classes as .qoi: (streams, native pixels) of the 4096
    RGBA and the 4096 RGB 64x64 icons in one list."""
    from seqoia_tpu_torch import native

    streams, pixels = [], []
    for px, ch in icon_px.values():
        if ch >= 3:
            streams += [native.encode(p, 64, 64, ch, 0, 1) for p in px]
            pixels += list(px)
    return streams, pixels


def _mesh_of(dev):
    """The mesh path's mesh: every card when there are several, else
    ``dev`` four times (the four-way split on one card). Returns (mesh,
    what it is)."""
    import torch

    from seqoia_tpu_torch.parallel import default_mesh

    if torch.cuda.device_count() > 1:
        mesh = default_mesh()
        return mesh, f"default_mesh(): {len(mesh)} cards"
    mesh = default_mesh([dev] * 4)
    return mesh, (f"({dev},) * 4 on one card: cross-card launches were not "
                  "exercised")


def mesh_path(large, stages, qstages, icon_classes, icon_px, qoi_icons,
              mesh, dev):
    """Every large-image function on the 134 Mpx RGB image, and BatchDecoder
    and BatchEncoder on the 32 photos, the icon classes and the .qoi photos
    and icons, each without a mesh and with ``mesh=``, warmed and then
    timed once; the mesh's output byte-equal to the other's. Returns
    [(call, seconds without the mesh, seconds with it)]."""
    import seqoia_tpu_torch as st

    rows = []
    n_sh = len(mesh)

    def both(name, single, meshed, same):
        """Each form once to warm it (pinned buffers, copy streams), then
        once timed."""
        outs, secs = [], []
        for fn in (single, meshed):
            fn()
            _sync_all()
            t = time.perf_counter()
            outs.append(fn())
            _sync_all()
            secs.append(time.perf_counter() - t)
        rows.append((name, *secs))
        a, b = outs
        if not same(a, b):
            raise AssertionError(f"mesh path: {name} differs from the call "
                                 "without a mesh")

    def same_pixels(a, b):
        return np.array_equal(a[0], b[0]) and a[1] == b[1]

    def same_results(a, b):
        return len(a) == len(b) and all(
            x.error == y.error and (x.pixels is None) == (y.pixels is None)
            and (x.pixels is None or np.array_equal(x.pixels, y.pixels))
            for x, y in zip(a, b))

    _, pixels, w, h, ch = next(x for x in large if x[0] == "large_rgb")
    desc = st.SqoaDesc(w, h, ch)
    stream = st.encode_large(pixels, desc, device=dev)
    both("large_rgb encode_large",
         lambda: st.encode_large(pixels, desc, device=dev),
         lambda: st.encode_large(pixels, desc, mesh=mesh), bytes.__eq__)
    both(f"large_rgb encode_large_shardmap ({n_sh} shards)",
         lambda: st.encode_large_shardmap(pixels, desc, n_shards=n_sh,
                                          device=dev),
         lambda: st.encode_large_shardmap(pixels, desc, mesh=mesh),
         lambda a, b: a == b == stream)
    both("large_rgb decode_large",
         lambda: st.decode_large(stream, device=dev),
         lambda: st.decode_large(stream, mesh=mesh), same_pixels)
    both(f"large_rgb decode_large_shardmap ({n_sh} shards)",
         lambda: st.decode_large_shardmap(stream, n_shards=n_sh, device=dev),
         lambda: st.decode_large_shardmap(stream, mesh=mesh), same_pixels)

    by = {s.name: s for s in list(stages) + list(qstages)}
    icons = [x for v in icon_classes.values() for x in v]
    icon_pix = [(p, ch) for px, ch in icon_px.values() for p in px]
    qoi_streams, qoi_pixels = qoi_icons
    for name, streams in (
            ("batch_rgb", by["batch_rgb"].streams),
            (f"icons ({len(icons)} x 64x64)", icons),
            ("batch_rgb_qoi", by["batch_rgb_qoi"].streams),
            (f".qoi icons ({len(qoi_streams)} x 64x64)", qoi_streams)):
        both(f"{name} BatchDecoder",
             lambda: st.BatchDecoder(device=dev)(streams),
             lambda: st.BatchDecoder(mesh=mesh)(streams), same_results)
    D = st.SqoaDesc
    photos = by["batch_rgb"]
    for name, px, descs in (
            ("batch_rgb", photos.pixels,
             [D(photos.w, photos.h, 3)] * len(photos.pixels)),
            (f"icons ({len(icon_pix)} x 64x64)", [p for p, _ in icon_pix],
             [D(64, 64, c) for _, c in icon_pix]),
            ("batch_rgb as .qoi", photos.pixels,
             [D(photos.w, photos.h, 3, 0, 1)] * len(photos.pixels)),
            (f".qoi icons ({len(qoi_pixels)} x 64x64)", qoi_pixels,
             [D(64, 64, p.size // 4096, 0, 1) for p in qoi_pixels])):
        both(f"{name} BatchEncoder",
             lambda: st.BatchEncoder(device=dev)(px, descs),
             lambda: st.BatchEncoder(mesh=mesh)(px, descs), list.__eq__)
    return rows


def dispatch_timing(qstages, qoi_icons, dev):
    """BatchDecoder on the 32 photos as .qoi and on the .qoi icons under
    each SEQOIA_COMPAT_CUDA policy: one warm-up call held to the native
    decoder, then the median, least and most seconds of DISPATCH_RUNS
    calls. Returns {list: {policy: (median, least, most, host rows)}}."""
    import statistics

    import torch

    import seqoia_tpu_torch as st

    photos = next(s for s in qstages if s.name == "batch_rgb_qoi")
    out = {}
    saved = os.environ.get("SEQOIA_COMPAT_CUDA")
    try:
        for name, streams, want in (
                ("batch_rgb_qoi (32 x 1024x1024)", photos.streams,
                 photos.pixels),
                (f".qoi icons ({len(qoi_icons[0])} x 64x64)", *qoi_icons)):
            row = out[name] = {}
            for mode in ("1", "0", "auto"):
                os.environ["SEQOIA_COMPAT_CUDA"] = mode
                dec = st.BatchDecoder(device=dev)
                res = dec(streams)
                bad = [i for i, (r, w) in enumerate(zip(res, want))
                       if not np.array_equal(r.pixels, w)]
                if bad:
                    raise AssertionError(f"{name} under SEQOIA_COMPAT_CUDA="
                                         f"{mode}: streams {bad[:8]} differ")
                secs = []
                for _ in range(DISPATCH_RUNS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    dec(streams)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                row[mode] = (statistics.median(secs), min(secs), max(secs),
                             dec.last_stats["host_rows"])
    finally:
        if saved is None:
            os.environ.pop("SEQOIA_COMPAT_CUDA", None)
        else:
            os.environ["SEQOIA_COMPAT_CUDA"] = saved
    return out


def _qoi_images(images):
    """The .qoi workloads: the SQOA path's RGBA photo and 32 RGB photos,
    the INDEX chain and the value chain."""
    by_name = {name: (px, w, h, ch) for name, px, w, h, ch in images}
    chain, n = _chain()
    deep, n_deep = _value_chain(2000)
    return [
        ("photo_rgba_qoi",) + by_name["photo_rgba"],
        ("batch_rgb_qoi",) + by_name["batch_rgb"],
        ("index_chain", [chain], n, 1, 4),
        ("value_chain", [deep], n_deep, 1, 4),
    ]


# --- the stream's end: every decode entry point against native.decode -------

END_FUZZ = 2000  # seeded malformed streams through each entry point
END_OUT_CH = (0, 2, 4)


def _end_edges():
    """The edge streams of tests/test_torch_stream_end.py, as {entry
    group: [streams]}: every last op of ``corpus.END_OPS`` at channels 1-4
    with a clean marker and an alpha-range byte at each of its 8 bytes, as
    icons (``icon``: a power-of-two pixel count, packed by BatchDecoder),
    one column wider (``plain``: a BatchDecoder class of rows) and with
    a REF op in the body (``ref``: all of them reach K10 under
    SEQOIA_REF_CUDA=1)."""
    from seqoia_tpu_torch.utils import corpus

    return {g: [corpus.stream_end_stream(ch, last, pos, ref=g == "ref",
                                         icon=g != "plain")
                for last in corpus.END_OPS for ch in (1, 2, 3, 4)
                for pos in (None,) + tuple(range(8))]
            for g in ("icon", "plain", "ref")}


def _keep_k1(out, data, chunks_len, n_max, mode="alpha", seg=None,
             seg_px=None):
    """A K1 launch on the host (a ``keep`` function of _census): in row mode each row up to 8 bytes past the
    longest stream (the plain version reads no further) and the ops below
    the largest total."""
    keys, pays, tot, ref = out
    t = int(tot.max()) if tot.numel() else 0
    if seg is None:
        data = data[:, : max(int(chunks_len.max()), 0) + 8]
    return ("K1" if seg is None else "K1seg", data.cpu(), chunks_len.cpu(),
            n_max, mode, seg, seg_px, keys[:, :t].cpu(), pays[:, :t].cpu(),
            tot.cpu(), ref.cpu())


def _keep_k10(out, data, chunks_len, n_pixels, *, colch, out_ch, n_max):
    px, err, ops = out
    return ("K10", data.cpu(), chunks_len, n_pixels, colch, out_ch, n_max,
            px.cpu(), bool(err), int(ops))


def stream_end_path(dev):
    """Every decode entry point on the card at the end of the stream, where
    the reference peeks for an alpha modifier after the last op
    (seqoia.h:777-783): the edge streams (_end_edges) at out_ch 0, 2 and 4
    and END_FUZZ seeded malformed streams (corpus.malformed_streams: body
    bytes overwritten, bodies cut short, marker bytes overwritten; out_ch
    0, 2, 4 in turn) through decode, decode_large, decode_large_shardmap at
    4 shards and with mesh=(dev,) * 4, BatchDecoder (the icons, which it
    packs, with the plain class; the fuzz streams in one call an out_ch)
    and decode with SEQOIA_REF_CUDA=1 (the edge streams with a REF op, and
    the fuzz), every output equal to native.decode's (None where it
    refuses the stream). Returns ({entry: decodes}, {entry: mismatches},
    seconds); main runs it under _census, which keeps host copies of each
    K1 and K10 launch (_keep_k1, _keep_k10) for _end_launches_held."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.utils import corpus

    t0 = time.perf_counter()
    edges = _end_edges()
    fuzz = corpus.malformed_streams(END_FUZZ)
    calls = {
        "decode": lambda s, c: st.decode(s, c, device=dev)[0],
        "decode_large": lambda s, c: st.decode_large(s, c, device=dev)[0],
        "decode_large_shardmap": lambda s, c: st.decode_large_shardmap(
            s, c, n_shards=4, device=dev)[0],
        "decode_large_shardmap mesh": lambda s, c: st.decode_large_shardmap(
            s, c, mesh=(dev,) * 4)[0],
        "decode SEQOIA_REF_CUDA=1": lambda s, c: st.decode(s, c,
                                                           device=dev)[0],
    }
    dec = st.BatchDecoder(device=dev)
    # (entry, streams, out_ch) a run; BatchDecoder takes a list a call
    work = []
    for oc in END_OUT_CH:
        k = END_OUT_CH.index(oc)
        for entry in calls:
            edge = edges["ref" if "REF" in entry else "icon"]
            work.append((entry, edge + fuzz[k::3], oc))
        work.append(("BatchDecoder", edges["icon"] + edges["plain"], oc))
        work.append(("BatchDecoder", fuzz[k::3], oc))
    decodes, bad = {}, {}
    old = os.environ.get("SEQOIA_REF_CUDA")
    try:
        for entry, streams, oc in work:
            os.environ["SEQOIA_REF_CUDA"] = "1" if "REF" in entry else ""
            if entry == "BatchDecoder":
                got = [r.pixels for r in dec(streams, oc)]
            else:
                got = [calls[entry](s, oc) for s in streams]
            want = [native.decode(s, oc)[0] for s in streams]
            decodes[entry] = decodes.get(entry, 0) + len(streams)
            bad[entry] = bad.get(entry, 0) + sum(
                (g is None) != (w is None)
                or w is not None and not np.array_equal(g, w)
                for g, w in zip(got, want))
    finally:
        if old is None:
            del os.environ["SEQOIA_REF_CUDA"]
        else:
            os.environ["SEQOIA_REF_CUDA"] = old
    return decodes, bad, time.perf_counter() - t0


def _end_launches_held(log, dev, rows=256):
    """Each K1 and K10 launch of stream_end_path against its plain version
    on the copies of its arguments, bitwise: K1's totals, flags, and keys
    and payloads below the totals, the plain version on the card (row
    mode: the rows of one n_max and mode, sorted by length, ``rows`` at a
    time through one plain call); K10's pixels, err and ops walked, the
    plain walk on the host. Returns ({kernel: launches held}, {kernel:
    modes seen}, the largest difference, seconds)."""
    import torch
    import torch.nn.functional as F

    from seqoia_tpu_torch.ops import frontend, ref

    t0 = time.perf_counter()
    held, modes, err = {"K1": 0, "K1seg": 0, "K10": 0}, {}, 0
    groups = {}
    for r in log:
        kid = r[0]
        held[kid] += 1
        if kid == "K10":
            _, data, clen, n, colch, oc, n_max, px, e, ops = r
            want, w_err, w_ops = ref.ref_decode_plain(
                data, clen, n, colch=colch, out_ch=oc, n_max=n_max)
            err = max(err, _max_err(px, want), int(e != bool(w_err)),
                      abs(ops - int(w_ops)))
            continue
        data, clen, n_max, mode, seg, seg_px = r[1:7]
        modes.setdefault(kid, set()).add(mode)
        if kid == "K1seg":
            plain = frontend.decode_front_plain_seg(
                data.to(dev), clen.to(dev), n_max, mode, seg, seg_px)
            err = max(err, _k1_err(r[7:], *(t.cpu() for t in plain)))
        else:
            groups.setdefault((n_max, mode), []).append(r)
    for (n_max, mode), recs in groups.items():
        recs.sort(key=lambda r: r[1].shape[1])
        for i in range(0, len(recs), rows):
            part = recs[i: i + rows]
            width = part[-1][1].shape[1]
            data = torch.cat([F.pad(r[1], (0, width - r[1].shape[1]))
                              for r in part])
            pk, pp, pt, pr = (t.cpu() for t in frontend.decode_front_plain(
                data.to(dev), torch.cat([r[2] for r in part]).to(dev), n_max,
                mode))
            at = 0
            for r in part:
                b = r[1].shape[0]
                s = slice(at, at + b)
                err = max(err, _k1_err(r[7:], pk[s], pp[s], pt[s], pr[s]))
                at += b
    return held, modes, err, time.perf_counter() - t0


def _k1_err(got, pk, pp, pt, pr):
    """The largest difference between a K1 launch's host outputs (keys and
    payloads up to the largest total, totals, flags) and the plain ones."""
    keys, pays, tot, ref = got
    t = keys.shape[1]
    return max(_max_err(tot, pt), _max_err(ref, pr),
               _max_err(_live(keys, tot), pk[:, :t]),
               _max_err(_live(pays, tot), pp[:, :t]))


# per kernel wrapper: (its kernel id from its bound arguments, the launch's
# shape, the bytes its bound counts: an int plus 0-d tensors summed later)
_CENSUS = {
    "decode_front_compact": (
        lambda a: "K1" if a["seg"] is None else "K1seg",
        lambda a, o: (f"{tuple(a['data'].shape)} {a['mode']}"
                      + (f" seg={a['seg']}" if a["seg"] else "")),
        lambda a, o: (4 * a["chunks_len"].numel() + 8 * len(o[2]),
                      [a["chunks_len"].sum(), 8 * o[2].sum()])),
    "place_emit": (
        lambda a: "K2",
        lambda a, o: (f"epilogue {_EPILOGUES[a['epilogue'].kind]} "
                      f"rows={a['keys'].shape[0]} n_out={a['n_out']}"),
        lambda a, o: (o.numel() * o.element_size(),
                      [4 * (1 + len(a["payloads"])) * a["totals"].sum()])),
    "encode_front_compact": (
        lambda a: "K3",
        lambda a, o: f"{tuple(a['packed'].shape)} colch={a['colch']}",
        lambda a, o: (4 * a["packed"].numel() + 24 * len(o[2]),
                      [12 * o[2].sum()])),
    "pack_words": (
        lambda a: "K4",
        lambda a, o: f"stride={a['stride']} {tuple(a['words'].shape)}",
        lambda a, o: (4 * a["words"].numel() + 4 * o.numel(), [])),
    "compact": (
        lambda a: "K5",
        lambda a, o: (f"{tuple(a['valid'].shape)} "
                      f"payloads={len(a['payloads'])}"),
        lambda a, o: (a["valid"].numel() + 4 * len(o[2]),
                      [8 * (1 + len(a["payloads"])) * o[2].sum()])),
    "place_fill": (
        lambda a: "K6",
        lambda a, o: (f"streams={len(o)} rows={a['keys'].shape[0]} "
                      f"n_out={a['n_out']}"),
        lambda a, o: (4 * len(o) * o[0].numel(),
                      [4 * (1 + len(a["payloads"])) * a["totals"].sum()])),
    "slot_last_writer": (
        lambda a: "K7",
        lambda a, o: f"{tuple(a['hashes'].shape)} slots={a['n_slots']}",
        lambda a, o: (12 * a["hashes"].numel(), [4 * _queries(a)])),
    "tile_scan": (
        lambda a: "K8",
        lambda a, o: f"{a['combine']} {tuple(a['arrays'][0].shape)}",
        lambda a, o: (8 * len(a["arrays"]) * a["arrays"][0].numel(), [])),
    "sequential_decode": (
        lambda a: "K9mono" if a["colch"] == 1 else "K9",
        lambda a, o: f"{tuple(a['lo'].shape)} colch={a['colch']}",
        lambda a, o: (4 * len(a["totals"]),
                      [(8 if a["colch"] == 1 else 12) * a["totals"].sum()])),
    "ref_decode": (
        lambda a: "K10",
        lambda a, o: (f"m={a['data'].numel()} n_pixels={a['n_pixels']} "
                      f"colch={a['colch']} out_ch={a['out_ch']}"),
        lambda a, o: (a["chunks_len"] + a["n_pixels"] * a["out_ch"], [])),
    "op_values": (
        lambda a: "K11",
        lambda a, o: (f"values{'' if a['hashes'] else ' without hashes'} "
                      f"{tuple(a['lo'].shape)}"),
        lambda a, o: ((20 if a["hashes"] else 16) * a["lo"].numel()
                      + 4 * len(a["totals"]), [])),
    "settled": (
        lambda a: "K11",
        lambda a, o: f"settled {tuple(a['got'].shape)}",
        lambda a, o: (8 * a["got"].numel() + len(o), [])),
}


def _queries(a):
    """K7's live queries (the bytes of its answers), as a 0-d tensor."""
    import torch

    q = a["qslots"]
    live = torch.ones_like(q, dtype=torch.bool)
    if a["n_live"] is not None:
        idx = torch.arange(q.shape[1], device=q.device)[None, :]
        live = idx < a["n_live"].long()[:, None]
    return ((q >= 0) & (q < a["n_slots"]) & live).sum()


class _LibProxy:
    """A kernel library whose C entry points record a pair of CUDA events
    around each call, into ``pending``: the time of the launch's kernels on
    the card, without the wrapper's host work (allocations) around it."""

    def __init__(self, lib, pending):
        self._lib, self._pending = lib, pending

    def __getattr__(self, name):
        import torch

        fn = getattr(self._lib, name)

        def call(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            rc = fn(*a)
            ev[1].record()
            self._pending.append(ev)
            return rc
        return call


class _Timed:
    """A kernel wrapper that notes each of its launches: its shape, the
    bytes its bound counts and the events its library recorded (_LibProxy),
    and, given ``keep``, calls ``keep(out, **arguments)`` after each launch
    (host copies to check later). A call launched when the program's
    launch counters (``kernels.launches.*``) moved over it."""

    def __init__(self, fn, spec, log, pending, keep=None):
        import inspect

        self.fn, self.spec, self.log, self.pending = fn, spec, log, pending
        self.keep, self.sig = keep, inspect.signature(fn)

    @staticmethod
    def _n():
        """Every kernel launch so far (K1's segment and mono modes counted
        once)."""
        from seqoia_tpu_torch.utils import trace

        return sum(v for k, v in trace.counters().items()
                   if k.startswith("kernels.launches.")
                   and k not in ("kernels.launches.K1.seg",
                                 "kernels.launches.K1.mono"))

    def __call__(self, *a, **k):
        n0, p0 = self._n(), len(self.pending)
        out = self.fn(*a, **k)
        ev = self.pending[p0:]
        del self.pending[p0:]
        if self._n() != n0:
            b = self.sig.bind(*a, **k)
            b.apply_defaults()
            kid_of, shape_of, bytes_of = self.spec
            args = b.arguments
            self.log.append((kid_of(args), shape_of(args, out),
                             bytes_of(args, out), ev))
            if self.keep is not None:
                self.keep(out, **args)
        return out


def _census(run, keep=None):
    """Run ``run()`` with every kernel wrapper noting its launches (_Timed)
    and every kernel library timing its C entry points (_LibProxy); ``keep``
    ({wrapper name: function}) gives wrappers their _Timed ``keep``. Returns
    ({kernel: {shape: [launches, ms, bound ms]}}, run's result): each
    launch's time on the card, in place, and its bound at its own shape."""
    import torch

    from seqoia_tpu_torch.ops import (_build, compact, encode_front, engine,
                                      fixpoint, frontend, pack, ref, scan,
                                      sequential, slots)

    log, pending, saved = [], [], []
    libs = {name: _build.load(name) for name in _build.KERNELS}
    for mod in (frontend, engine, encode_front, pack, compact, slots, scan,
                sequential, ref, fixpoint):
        for name, spec in _CENSUS.items():
            fn = getattr(mod, name, None)
            if fn is not None and getattr(fn, "__module__", "") == \
                    mod.__name__:
                saved.append((mod, name, fn))
                setattr(mod, name, _Timed(fn, spec, log, pending,
                                          (keep or {}).get(name)))
    _build._libs.update({n: _LibProxy(lib, pending)
                         for n, lib in libs.items()})
    try:
        out = run()
    finally:
        _build._libs.update(libs)
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    _sync_all()
    table = {}
    for kid, shape, (nbytes, parts), evs in log:
        nbytes += sum(int(p) for p in parts)
        row = table.setdefault(kid, {}).setdefault(shape, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += sum(e0.elapsed_time(e1) for e0, e1 in evs)
        row[2] += nbytes / HBM_BYTES_PER_S * 1e3
    return table, out


def _counted(counters, run, gaps, keep=None):
    """Launches of each kernel during run(), ``counters`` ({kernel: the
    program's counter name}) read just before it and just after; each
    launch's time and bound are added to gaps ({kernel: {shape: [launches,
    ms, bound ms]}}, _census, which takes ``keep``). Returns (launches,
    run's result, the run's own census table)."""
    from seqoia_tpu_torch.utils import trace

    before = trace.counters()
    table, out = _census(run, keep)
    after = trace.counters()
    for kid, shapes in table.items():
        for shape, (n, ms, bound) in shapes.items():
            row = gaps.setdefault(kid, {}).setdefault(shape, [0, 0.0, 0.0])
            row[0] += n
            row[1] += ms
            row[2] += bound
    return ({k: after.get(c, 0) - before.get(c, 0)
             for k, c in counters.items()}, out, table)


def _one_front_one_k2(path, table, calls):
    """Fails unless every encode call of a path (``calls``: (rows, K2's
    cap or None for any, SQOA) each) ran exactly one K2 with an encode
    epilogue, at its cap, and the SQOA calls one K3 each: no retry at a
    larger cap, no second front."""
    import re

    got = []
    for shape, (n, _, _) in table.get("K2", {}).items():
        m = re.match(r"epilogue encode \w+ rows=(\d+) n_out=(\d+)$", shape)
        if m:
            got += [(int(m[1]), int(m[2]))] * n
    left = list(got)
    for rows, cap, _ in sorted(calls, key=lambda c: c[1] is None):
        hit = next((g for g in left if g[0] == rows
                    and (cap is None or g[1] == cap)), None)
        if hit is None:
            raise AssertionError(f"the {path} path: no K2 encode launch at "
                                 f"rows={rows} cap={cap}; launched {got}")
        left.remove(hit)
    if left:
        raise AssertionError(f"the {path} path launched K2's encode {len(got)} "
                             f"times in {len(calls)} encode calls: {got}")
    k3 = sum(r[0] for r in table.get("K3", {}).values())
    if k3 != sum(sqoa for _, _, sqoa in calls):
        raise AssertionError(f"the {path} path launched K3 {k3} times in "
                             f"{sum(c[2] for c in calls)} SQOA encode calls")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from seqoia_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    # the paths below hold the .qoi kernels on the card whatever the batch
    # policy's default; dispatch_timing sets each policy in turn
    os.environ["SEQOIA_COMPAT_CUDA"] = "1"

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"built {sorted(logs)} in {build_s:.1f} s")
    fn = ""
    for line in logs.get("ref", "").splitlines():
        if "Compiling entry function" in line:
            fn = next((v for k, v in (
                ("k10_walkILi1", "k10_walk<1>"), ("k10_walkILi3", "k10_walk<3>"),
                ("k10_fill", "k10_fill"), ("k10_chase", "k10_chase"))
                if k in line), line.strip())
        if "registers" in line or "spill" in line:
            print(f"K10 ptxas {fn}: {line.strip()}")
    print(f"K10 k10_walk dynamic shared memory: "
          f"{_build.load('ref').k10_shared_bytes()} bytes")

    t0 = time.perf_counter()
    images = _images()
    stages = [Stages(*img, dev) for img in images]
    qstages = [Stages(*img, dev, compat=1) for img in _qoi_images(images)]
    large = _large_images(images)
    classes, mixed, ref_stream, icon_px = _icon_streams(images, qstages)
    enc_sets = _encode_sets(stages, qstages, (icon_px, classes))
    mono_big, mono_mixed = _mono_inputs(qstages)
    ref_small, ref_big = _ref_inputs(stages)
    qoi_icons = _qoi_icons(icon_px)
    pages = _page_streams()
    mesh, mesh_what = _mesh_of(dev)
    print(f"made and encoded (native) the inputs in "
          f"{time.perf_counter() - t0:.1f} s")

    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    rec = timed("check_kernels", check_kernels, stages, dev)
    for k, rows in timed("check_qoi_kernels", check_qoi_kernels, qstages,
                         dev).items():
        rec[k] += rows
    rec["K4"] = timed("check_pack_kernel", check_pack_kernel, large, dev)
    rec["K1seg"] = timed("check_segment_kernel", check_segment_kernel,
                         classes, dev)
    rec["K1"].append(timed("check_saturation", check_saturation, dev))
    for k, rows in timed("check_path_kernels", check_path_kernels, large,
                         classes, mixed, pages, enc_sets, dev).items():
        rec[k] += rows
    rec["K2"] += timed("check_conversions", check_conversions, pages, dev)
    rec["K9mono"] = timed("check_mono_k9", check_mono_k9, mono_big,
                          mono_mixed, dev)
    rec["K10"] = timed("check_ref_k10", check_ref_k10, ref_small, ref_big,
                       dev)
    load_ns, load_cycles = timed("smem_load_ns", smem_load_ns, dev)
    print(f"one dependent shared-memory load (k9_smem_chase): {load_ns:.4f} "
          f"ns, {load_cycles:.2f} SM cycles")
    ldg = timed("ldg_load_ns", ldg_load_ns, dev)
    for region, (ns, cyc) in ldg.items():
        print(f"one dependent __ldg byte read over {region} (k10_ldg_chase): "
              f"{ns:.4f} ns, {cyc:.2f} SM cycles")
    edges = timed("check_edge_kernels", check_edge_kernels, dev)
    edges.update(timed("check_edge_engine", check_edge_engine, dev))
    edges["K7"] = timed("check_edge_slots", check_edge_slots, dev)
    edges["K1"] = timed("check_edge_front", check_edge_front, stages, dev)
    edges["K3"] = timed("check_edge_encode_front", check_edge_encode_front,
                        dev)
    edges["K1seg"] = timed("check_edge_segments", check_edge_segments, dev)
    print("seconds a check: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in phase_s.items()))
    for k, rows in edges.items():
        print(f"{k} at {len(rows)} edge shapes: max err "
              f"{max(r['err'] for r in rows)}")
        rec[k] += rows
    for k, rows in rec.items():
        for r in rows:
            if "ms" not in r:
                continue
            lib = ("" if r.get("library_ms") is None
                   else f" library {r['library_ms']:.3f} ms")
            cold = ("" if "cold_ms" not in r else
                    f" L2-flushed {r['cold_ms']:.4f} ms, "
                    f"{r['repeats_differ']}/{REPEATS} repeats differ")
            if "device_ms" in r:
                cold += (", device not measured (no event in the trace)"
                         if r["device_ms"] is None
                         else f", device {r['device_ms']:.4f} ms")
            if "replaced_ms" in r:
                cold += (f"; the route it replaced (K6, then torch ops) "
                         f"{r['replaced_ms']:.4f} ms")
            plain = ("plain not run (one op a step)" if r["plain_ms"] is None
                     else f"plain {r['plain_ms']:.3f} ms")
            if "ops" in r:  # K10: one thread walks a stream's ops
                cold += (f", {r['ms'] * 1e6 / max(r['ops'], 1):.1f} ns an "
                         f"op over {r['ops']} ops, chain bound "
                         f"{r['ops'] * load_ns * 1e-6:.4f} ms, "
                         f"{r['repeats_differ']}/{REPEATS} repeats differ")
            if "longest" in r:  # K9: rows run side by side, ops in turn
                cold += (f", {r['ms'] * 1e6 / max(r['longest'], 1):.1f} ns "
                         f"an op of the longest row, chain bound "
                         f"{r['longest'] * load_ns * 1e-6:.4f} ms, "
                         f"{r['repeats_differ']}/{REPEATS} repeats differ")
            print(f"{k} {r['shape']}: err {r['err']} kernel {r['ms']:.4f} ms "
                  f"{plain} bound "
                  f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms{lib}{cold}")
    for r in rec["K8"]:
        if r["shape"].startswith(("photo_rgba_qoi decode ops sum",
                                  "batch_rgb_qoi decode ops sum")):
            print(f"K8 sum {r['shape'].split(' sum ')[1]}: kernel "
                  f"{r['ms']:.4f} ms, torch.cumsum {r['library_ms']:.4f} ms")
    bad = [k for k, rows in rec.items()
           if any(r["err"] or r.get("repeats_differ") for r in rows)]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions or "
                             f"between launches: {bad}")

    counters = {k: "kernels.launches." + k for k in (
        "K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K11")}
    counters["K1seg"] = "kernels.launches.K1.seg"
    counters["K9mono"] = "kernels.launches.K9.mono"
    torch.cuda.reset_peak_memory_stats()
    gaps = {}
    sqoa_launches, (rates, calls), table = _counted(
        counters, lambda: main_path(stages, dev), gaps)
    _one_front_one_k2("SQOA", table, calls)
    # the .qoi path must stay on the card: count the host decodes it makes
    dec_mod = importlib.import_module("seqoia_tpu_torch.codec.decode")
    host, host_calls = dec_mod._host, []
    dec_mod._host = lambda *a: host_calls.append(1) or host(*a)
    try:
        qoi_launches, (qoi_rates, fix, calls), table = _counted(
            counters, lambda: qoi_path(qstages, dev), gaps)
    finally:
        dec_mod._host = host
    if host_calls:
        raise AssertionError(f"{len(host_calls)} .qoi decodes went to the host")
    _one_front_one_k2(".qoi", table, calls)
    large_launches, (large_rates, rgb_stream, calls), table = _counted(
        counters, lambda: large_path(large, dev), gaps)
    _one_front_one_k2("large-image", table, calls)
    if large_launches["K4"] != 3:
        raise AssertionError(f"K4 ran {large_launches['K4']} times, not once "
                             "per stride")
    icon_launches, (icon_rates, timings), _ = _counted(
        counters, lambda: icon_path(classes, mixed, ref_stream, dev), gaps)
    enc_launches, (enc_rates, enc_timings, calls, k4_due), table = _counted(
        counters, lambda: batch_encode_path(enc_sets, dev), gaps)
    _one_front_one_k2("batch-encode", table, calls)
    if enc_launches["K4"] != k4_due:
        raise AssertionError(f"the batch-encode path ran K4 "
                             f"{enc_launches['K4']} times, not once per "
                             f"class of stride 1-3 ({k4_due})")
    mono_launches, (mono_rates, mono_timings), _ = _counted(
        counters, lambda: mono_qoi_path(mono_big, mono_mixed, dev), gaps)
    timings += mono_timings
    ref_launches, ref_rates, _ = _counted(
        counters, lambda: timed("ref_path", ref_path, ref_big, dev), gaps)
    mesh_launches, mesh_rows, _ = _counted(
        counters, lambda: timed("mesh_path", mesh_path, large, stages,
                                qstages, classes, icon_px, qoi_icons, mesh,
                                dev), gaps)
    with tempfile.TemporaryDirectory() as tmp:
        tool_launches, (corpus_dir, tool_s, fuzz_k10), _ = _counted(
            counters, lambda: timed("tool_path", tool_path, tmp, dev), gaps)
        # the same bench again, BENCH_RUNS times outside the census (which
        # times each launch of the counted run): the tables to read, and
        # their spread (one image a call, host-bound)
        bench_tables = timed("bench", lambda: [
            _bench(corpus_dir, dev) for _ in range(BENCH_RUNS)])
    dispatch = timed("dispatch_timing", dispatch_timing, qstages, qoi_icons,
                     dev)
    end_log = []
    end_launches, (end_decodes, end_bad, end_s), _ = _counted(
        counters, lambda: timed("stream_end_path", stream_end_path, dev),
        gaps, keep={
            "decode_front_compact": lambda out, **a: end_log.append(
                _keep_k1(out, **a)),
            "ref_decode": lambda out, **a: end_log.append(
                _keep_k10(out, **a))})
    end_held, end_modes, end_err, held_s = timed(
        "end_launches_held", _end_launches_held, end_log, dev)
    del end_log
    print(f"stream_end_path: {len(_end_edges()['icon'])} edge streams a "
          f"group (icon, plain, REF) and {END_FUZZ} fuzz streams, out_ch "
          f"0/2/4; decodes {end_decodes}; mismatches against native.decode "
          f"{end_bad}; launches held against the plain versions {end_held} "
          f"(K1 modes {({k: sorted(v) for k, v in end_modes.items()})}), "
          f"largest difference {end_err}; {end_s:.1f} s driving, "
          f"{held_s:.1f} s holding")
    if any(end_bad.values()) or end_err:
        raise AssertionError("the stream-end path differs from native.decode "
                             "or a kernel from its plain version")
    if (end_held["K1"] + end_held["K1seg"] != end_launches["K1"]
            or end_held["K1seg"] != end_launches["K1seg"]
            or end_held["K10"] != end_launches["K10"]
            or any(end_modes.get(k) != {"alpha", "noalpha", "mono"}
                   for k in ("K1", "K1seg"))
            or min(end_decodes.values()) < END_FUZZ):
        raise AssertionError(f"the stream-end path held {end_held} of "
                             f"{end_launches}, modes {end_modes}")
    for k in ("K1", "K1seg", "K10"):
        rec[k].append(dict(shape=f"stream_end_path, {end_held[k]} launches",
                           err=end_err, main=False))
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps = large_steps(large[0], rgb_stream, dev)
    paths = (("SQOA", sqoa_launches, SQOA_KERNELS),
             (".qoi", qoi_launches, QOI_KERNELS),
             ("large-image", large_launches, LARGE_KERNELS),
             ("icon", icon_launches, ICON_KERNELS),
             ("batch-encode", enc_launches, ENCODE_KERNELS),
             ("mono .qoi", mono_launches, MONO_KERNELS),
             ("REF", ref_launches, REF_KERNELS),
             ("tooling", tool_launches, TOOL_KERNELS),
             ("mesh", mesh_launches, MESH_KERNELS),
             ("stream-end", end_launches, END_KERNELS))
    for path, launches, kernels in paths:
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing}")
    launches = {k: sum(p[1][k] for p in paths) for k in counters}
    rates = (rates + qoi_rates + large_rates + icon_rates + enc_rates
             + mono_rates + ref_rates)
    # the census saw every counted launch (K1's counter counts both modes;
    # K9's the color step, K9mono's the mono step)
    seen = {k: sum(r[0] for r in gaps.get(k, {}).values()) for k in counters}
    seen["K1"] += seen["K1seg"]
    if seen != launches:
        raise AssertionError(f"the census timed {seen}, the counters "
                             f"counted {launches}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for phase, r in rates:
        print(f"{phase}: {r:.4g} Mpx/s")
    for what, ms in steps.items():
        print(f"large_rgb {what}: {ms:.1f} ms")
    for phase, t, st_ in timings:
        print(f"{phase} BatchDecoder seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f"; {st_}")
    for phase, t, st_ in enc_timings:
        print(f"{phase} BatchEncoder seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f"; {st_}")
    for f in fix:
        print(f"{f['workload']}: fixpoint converged {f['converged']}/"
              f"{f['rows']} rows in {f['passes']} passes; settled "
              f"{f['settled_rows']} rows on the card in {f['settle_passes']} "
              f"more, {f['sequential_rows']} of them by K9; probe: strict "
              f"INDEX-chain depth {f['strict_depth']}, "
              f"predicted {f['predicted_depth']}, {f['index_ops']} INDEX ops")
    print(f"launches on the SQOA path: {sqoa_launches}")
    print(f"launches on the .qoi path: {qoi_launches}")
    print(f"launches on the large-image path: {large_launches}")
    print(f"launches on the icon path: {icon_launches}")
    print(f"launches on the batch-encode path: {enc_launches}")
    print(f"launches on the mono .qoi path: {mono_launches}")
    print(f"launches on the REF path: {ref_launches}")
    print(f"launches on the tooling path: {tool_launches}")
    print(f"launches on the mesh path: {mesh_launches}")
    print(f"launches on the stream-end path: {end_launches}")
    print(f"mesh path on {mesh_what}; seconds without the mesh, with it:")
    for name, t1, tm in mesh_rows:
        print(f"  {name}: {t1:.4f} s, {tm:.4f} s")
    print(f".qoi batch policy (SEQOIA_COMPAT_CUDA), BatchDecoder median "
          f"seconds of {DISPATCH_RUNS} warm calls (least-most, host rows); "
          f"os.cpu_count() {os.cpu_count()}; {smi}:")
    for name, row in dispatch.items():
        print(f"  {name}: " + "; ".join(
            f"{m} {md:.4f} ({lo:.4f}-{hi:.4f}, {hr})"
            for m, (md, lo, hi, hr) in row.items()))
    print("seconds of the tooling path: " + ", ".join(
        f"{k} {v:.1f}" for k, v in tool_s.items()))
    for i, table in enumerate(bench_tables):
        print(f"bench --cuda over the corpus, run {i + 1} of "
              f"{BENCH_RUNS} ({smi}):")
        print(table, end="")
    spread = _bench_spread(bench_tables)
    for codec, ((d0, d1), (e0, e1)) in spread.items():
        print(f"bench spread over {BENCH_RUNS} runs, {codec}: decode "
              f"{d0}-{d1} Mpx/s, encode {e0}-{e1}")
    print(f"peak device memory of the main paths: {peak_gb:.2f} GiB")
    gap_ms = {}
    for k, shapes in sorted(gaps.items()):
        rows = sorted(shapes.items(), key=lambda kv: kv[1][2] - kv[1][1])
        n, ms, bound = (sum(r[i] for _, r in rows) for i in range(3))
        gap_ms[k] = ms - bound
        print(f"{k} summed gap over the main paths: {ms - bound:.4f} ms "
              f"({n} launches, {ms:.4f} ms against a bound of {bound:.4f}); "
              "largest: " + "; ".join(
                  f"{sh} x{r[0]}: {r[1] - r[2]:.4f}" for sh, r in rows[:3]))
    kernels = []
    for k, (fname, src, repl) in KERNELS.items():
        main = [r for r in rec[k] if r.get("main", True)]
        head = next((r for r in main if r.get("library_ms") is not None),
                    main[0])
        kernels.append(dict(
            name=f"{k} {fname}", route="cuda", source=src, replaces=repl,
            launches=launches[k],
            max_abs_err=max(r["err"] for r in rec[k]),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=head.get("library_ms"),
            shape=head["shape"], gap_ms=gap_ms.get(k)))
        if k in ("K9", "K9mono"):  # latency-bound: the chain bound too
            kernels[-1].update(
                chain_bound_ms=head["longest"] * load_ns * 1e-6,
                smem_load_ns=load_ns)
        if k == "K10":  # latency-bound: one thread walks the stream's ops
            kernels[-1].update(ops=head["ops"],
                               ns_per_op=head["ms"] * 1e6 / head["ops"],
                               chain_bound_ms=head["ops"] * load_ns * 1e-6,
                               smem_load_ns=load_ns,
                               ldg_load_ns={k_: v[0] for k_, v in
                                            ldg.items()})
        if k == "K9mono":  # the 4096x4096 launch, held to native.decode
            top = max(main, key=lambda r: r["longest"])
            kernels[-1].update(largest_shape=top["shape"],
                               largest_ms=top["ms"],
                               largest_bound_ms=top["bytes"]
                               / HBM_BYTES_PER_S * 1e3,
                               largest_chain_bound_ms=top["longest"]
                               * load_ns * 1e-6)
    total_s = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, build_s=build_s, total_s=total_s,
                       check_s=phase_s,
                       kernels=rec, rates=rates, fixpoint=fix,
                       launches=dict(sqoa=sqoa_launches, qoi=qoi_launches,
                                     large=large_launches,
                                     icon=icon_launches,
                                     batch_encode=enc_launches,
                                     mono_qoi=mono_launches,
                                     ref=ref_launches, tooling=tool_launches,
                                     mesh=mesh_launches,
                                     stream_end=end_launches),
                       stream_end=dict(decodes=end_decodes,
                                       mismatches=end_bad, held=end_held,
                                       err=end_err, seconds=end_s,
                                       held_s=held_s),
                       mesh=dict(mesh=mesh_what, seconds=mesh_rows),
                       dispatch=dict(cpu_count=os.cpu_count(),
                                     runs=DISPATCH_RUNS, seconds=dispatch),
                       bench_tables=bench_tables, bench_spread=spread,
                       tool_s=tool_s,
                       fuzz_k10_decodes=fuzz_k10,
                       large_rgb_steps_ms=steps,
                       batch_decoder=[dict(phase=p, timings=t, stats=s_)
                                      for p, t, s_ in timings],
                       batch_encoder=[dict(phase=p, timings=t, stats=s_)
                                      for p, t, s_ in enc_timings],
                       census=gaps, smem_load_ns=load_ns, ldg_load_ns=ldg,
                       peak_gib=peak_gb), f, indent=1)
    print(f"chip_smoke ran {total_s:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
