#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seqoia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the port from ``seqoia_tpu_torch/csrc`` (one
   nvcc per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card, on the
   inputs the main paths give it: integer data, so the comparison is
   bit-exact (tolerance 0). SQOA: K1 decode front, K2 placement with its
   decode and encode epilogues, K3 encode front, K6 placement fill. QOI
   (.qoi): the arguments of the first launch of K5 (compaction), K6, K7
   (slot last writer) and each K8 (scan) combine, recorded during one
   decode_stream_compat_batched / encode_stream_batched(compat=True) call
   per photo workload, and of K9 (the sequential decoder) in the value
   chain's decode; K8 sum and K7 at 128 slots (not on the path) at the
   decode's op shape.
3. Resets the kernels' launch counters and drives the SQOA path through the
   public entry points: one 4096x4096 RGBA photo-class image, a batch of
   32 1024x1024 RGB photos (decode_stream_batched / encode_stream_batched)
   and one 2048x2048 gray+alpha image (decoded as stored and with 4 forced
   channels); reads the counters; resets them again and drives the .qoi
   path: the same RGBA photo (seqoia_tpu_torch.encode / decode with
   qoi_compat=1), the same 32 photos as .qoi (encode_stream_batched with
   compat=True, decode_stream_compat_batched), the 61-link INDEX chain
   that the fixpoint cannot settle in its 12 passes, and a 2000-link chain
   of INDEX reads of DIFF-derived values, which its alpha-speculated
   restart cannot settle either (one resolution per link), so K9 decodes
   it. Every stream and every pixel the card returns is
   held byte-exact against the port's native C codec. Fails if a kernel of
   a path was not launched on it, if a .qoi stream went to the host
   decoder, or if an encode's cap is not the one its kernels were checked
   at.
4. Prints the card's name and power limit, each phase's Mpx/s, each .qoi
   workload's fixpoint (converged rows and passes, the rows settled after
   it and the resolutions that took) beside the INDEX-chain depth that
   ``native.compat_probe`` measures on its streams, each kernel's time
   beside its bound, a JSON ``kernels`` line and, last, ``{"ok": true,
   "device": {...}}``.

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
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
OUT_DIR = "chiprun_out"
REPS = 10  # timed launches per kernel and shape

KERNELS = {
    "K1": ("decode_front_compact", "seqoia_tpu_torch/csrc/frontend.cu",
           "seqoia_tpu/ops/pallas_frontend.py:620"),
    "K2": ("place_emit", "seqoia_tpu_torch/csrc/engine.cu",
           "seqoia_tpu/ops/pallas_engine.py:342"),
    "K3": ("encode_front_compact", "seqoia_tpu_torch/csrc/encode_front.cu",
           "seqoia_tpu/ops/pallas_encode.py:270"),
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
}
SQOA_KERNELS = ("K1", "K2", "K3", "K6")
QOI_KERNELS = ("K5", "K6", "K7", "K8", "K9")


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


def _plain_ms(fn):
    import torch

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
        from seqoia_tpu_torch.codec import normalize_pixels_packed
        from seqoia_tpu_torch.codec.encode import first_cap, pixel_bucket

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
        # the encode's power-of-two pixel bucket and the output cap its
        # first call per (colch, has_alpha, compat) uses: the shape of K2's
        # encode epilogue, or of the .qoi encode's K6 spread
        n_pad = pixel_bucket(self.n)
        packed = np.zeros((len(pixels), n_pad), np.int32)
        for i, p in enumerate(pixels):
            packed[i, : self.n] = normalize_pixels_packed(p, self.desc)
        self.packed_host = packed
        self.packed = torch.from_numpy(packed).to(dev)
        self.out_cap = first_cap(self.desc, n_pad)
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
            bytes=sum(len(x) for x in s.streams) + 8 * n_ops + 16 * bsz))
        del pk, pp
        # --- K2 decode epilogue, K6 ----------------------------------------
        npx = s.npx[:, None]
        if s.colch == 3:
            epi = decode_v2._dec_epilogue(s.out_ch)
        else:
            epi = decode_v2._dec_epilogue_mono(s.out_ch)

        def k2():
            return engine.place_emit(keys, [pays], tot, npx, s.n_max, init,
                                     epi)
        out = k2()
        ref_out, p_ms = _plain_ms(lambda: epi.plain(
            engine._fill_plain(keys, [pays], tot, s.n_max, init),
            torch.arange(s.n_max, device=dev)[None, :], npx.long()))
        rec["K2"].append(dict(
            shape=f"{s.name} decode out_ch={s.out_ch} n_out={s.n_max}",
            err=_max_err(out, ref_out), ms=_timed(k2), plain_ms=p_ms,
            bytes=8 * n_ops + out.numel() * out.element_size()))
        del out, ref_out
        if s.colch == 1:
            def k6():
                return engine.place_fill(keys, [pays], tot, s.n_max, init)
            (fk,) = k6()
            (fp,), p_ms = _plain_ms(lambda: engine._fill_plain(
                keys, [pays], tot, s.n_max, init))
            rec["K6"].append(dict(
                shape=f"{s.name} fill n_out={s.n_max}",
                err=_max_err(fk[:, : s.n], fp[:, : s.n]),
                ms=_timed(k6), plain_ms=p_ms,
                bytes=8 * n_ops + 4 * fk.numel()))
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
            bytes=4 * s.packed.numel() + 12 * n_ent + 24 * bsz))
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
            bytes=12 * n_ent + out.numel()))
        del out, ref_out, ek, ec, em
        torch.cuda.empty_cache()
    return rec


def main_path(stages, dev):
    """Decode and encode every workload through the public entry points,
    byte-exact against the native codec. Returns [(phase, Mpx/s)]."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.codec import decode_stream_batched
    from seqoia_tpu_torch.codec import encode_stream_batched
    from seqoia_tpu_torch.codec.encode import first_cap

    rates = []

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
                    torch.from_numpy(s.packed_host).to(dev), s.npx, colch=3,
                    out_cap=s.out_cap))
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
        cap = first_cap(s.desc, s.packed.shape[1])
        if cap != s.out_cap:
            raise AssertionError(f"{s.name}: encode cap {cap} is not the "
                                 f"checked {s.out_cap}")
        enc = clock(f"{s.name} encode (seqoia_tpu_torch.encode)", s.n,
                    lambda: st.encode(pixels, s.desc, device=dev))
        if enc != stream:
            raise AssertionError(f"{s.name}: encode differs")
    return rates


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
    """Run ``run()`` with the K5, K6, K7, K8 and K9 wrappers recording the
    arguments of their first launch (K8: per combine). Returns ({kernel:
    (args, kwargs)}, run's result)."""
    from seqoia_tpu_torch.ops import compact, engine, scan, sequential, slots

    seen = {}
    saved = []
    for mod, name, key in (
            (compact, "compact", lambda a, k: "K5"),
            (engine, "place_fill", lambda a, k: "K6"),
            (slots, "slot_last_writer", lambda a, k: "K7"),
            (scan, "tile_scan", lambda a, k: "K8 " + a[1]),
            (sequential, "sequential_decode", lambda a, k: "K9")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _key=key, **k):
            seen.setdefault(_key(a, k), (a, k))
            return _fn(*a, **k)

        # the wrapper counts its launches under its module name: while
        # recording, that name is rec
        rec.launches = 0
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

    from seqoia_tpu_torch.ops import compact, engine, scan, sequential, slots

    kid = key.split()[0]
    library = None
    if kid == "K8":
        arrays, combine = args
        run = lambda: scan.tile_scan(arrays, combine)  # noqa: E731
        got = run()
        want, p_ms = _plain_ms(lambda: scan.tile_scan_plain(arrays, combine))
        err = max(_max_err(g, w) for g, w in zip(got, want))
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
        idx = torch.arange(h.shape[1], device=h.device)[None, :]
        live = idx < n_live.long()[:, None]
        n_q = int(((q >= 0) & (q < n_slots) & live).sum())
        nbytes = 12 * h.numel() + 4 * n_q
        shape = f"{where} {tuple(h.shape)} slots={n_slots} queries={n_q}"
    elif kid == "K9":
        lo, hi, tot = args
        run = lambda: sequential.sequential_decode(lo, hi, tot)  # noqa: E731
        got = run()
        want, p_ms = _plain_ms(lambda: sequential.sequential_decode_plain(
            lo, hi, tot))
        err = _max_err(got, want)
        n_ops = int(tot.sum())
        nbytes = 12 * n_ops + 4 * len(tot)
        shape = f"{where} {tuple(lo.shape)} ops={n_ops}"
    else:  # K6
        keys, pays, tot, n_out, inits = args
        fill_keys = kw.get("fill_keys", False)
        run = lambda: engine.place_fill(keys, pays, tot, n_out,  # noqa
                                        inits, fill_keys=fill_keys)
        got = run()
        streams = list(pays) + ([keys] if fill_keys else [])
        want, p_ms = _plain_ms(lambda: engine._fill_plain(
            keys, streams, tot, n_out, inits))
        err = max(_max_err(g, w) for g, w in zip(got, want))
        n_ent = int(tot.sum())
        nbytes = 4 * (1 + len(pays)) * n_ent + 4 * len(streams) * got[0].numel()
        shape = (f"{where} streams={len(streams)} n_out={n_out} "
                 f"entries={n_ent}")
    return kid, dict(shape=shape, err=err, ms=_timed(run), plain_ms=p_ms,
                     bytes=nbytes, library_ms=library, main=True)


def check_qoi_kernels(qstages, dev):
    """K5, K6, K7 and K8 against their plain versions at the shapes the .qoi
    path gives them (recorded from one batched decode and one batched
    encode per photo workload), K9 at the value chain's, and, off the path,
    K8 sum and fill and K7 at 128 slots at the decode's op shape. Records
    each photo workload's fixpoint stats."""
    import torch

    from seqoia_tpu_torch.codec import (decode_stream_compat_batched,
                                        encode_stream_batched)

    rec = {k: [] for k in QOI_KERNELS}
    for s in qstages:
        if s.name == "index_chain":
            continue
        if s.name == "value_chain":
            seen, _ = _capture(lambda: decode_stream_compat_batched(
                s.data, s.clen, s.npx, colch=3, out_ch=4, n_max=s.n_max))
            kid, r = _check_qoi_call("K9", *seen["K9"], f"{s.name} decode")
            rec[kid].append(r)
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
        # K8's other two combines, on the op stream of the first segmod,
        # and K7 at 128 slots (the mono index), on the first resolution's
        # slots spread over 128 by the value's low bit
        ((seg,), _), _ = seen["K8 segmod"]
        (h, v, q), kw = seen["K7"]
        wide = [torch.where(x >= 0, x + 64 * (v & 1), -1) for x in (h, q)]
        for key, args, k in (
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
    [fixpoint record per workload])."""
    import torch

    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.codec import (decode_stream_compat_batched,
                                        encode_stream_batched)
    from seqoia_tpu_torch.codec.encode import first_cap

    rates, fix = [], []

    clock = functools.partial(_clock, rates)

    for s in qstages:
        if s.name == "batch_rgb_qoi":
            bsz = len(s.streams)
            out, total = clock(
                "batch .qoi encode (encode_stream_batched, compat)", bsz * s.n,
                lambda: encode_stream_batched(
                    torch.from_numpy(s.packed_host).to(dev), s.npx, colch=3,
                    out_cap=s.out_cap, compat=True))
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
            cap = first_cap(s.desc, s.packed_host.shape[1])
            if cap != s.out_cap:
                raise AssertionError(f"{s.name}: encode cap {cap} is not the "
                                     f"checked {s.out_cap}")
        enc = clock(f"{s.name} encode (seqoia_tpu_torch.encode)", s.n,
                    lambda: st.encode(pixels, s.desc, device=dev))
        if enc != stream:
            raise AssertionError(f"{s.name}: encode differs")
        got, desc = clock(f"{s.name} decode (seqoia_tpu_torch.decode)", s.n,
                          lambda: st.decode(stream, device=dev))
        if not np.array_equal(got, pixels) or desc.qoi_compat != 1:
            raise AssertionError(f"{s.name}: decode differs")
    return rates, fix


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


def _counted(counters, run):
    """Launches of each kernel during run(), the counters set to 0 just
    before it and read just after."""
    for fn in counters.values():
        fn.launches = 0
    out = run()
    return {k: fn.launches for k, fn in counters.items()}, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from seqoia_tpu_torch.ops import (_build, compact, encode_front,
                                          engine, frontend, scan, sequential,
                                          slots)
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"built {sorted(logs)} in {build_s:.1f} s")

    t0 = time.perf_counter()
    images = _images()
    stages = [Stages(*img, dev) for img in images]
    qstages = [Stages(*img, dev, compat=1) for img in _qoi_images(images)]
    print(f"made and encoded (native) the inputs in "
          f"{time.perf_counter() - t0:.1f} s")

    rec = check_kernels(stages, dev)
    for k, rows in check_qoi_kernels(qstages, dev).items():
        rec[k] += rows
    for k, rows in rec.items():
        for r in rows:
            lib = ("" if r.get("library_ms") is None
                   else f" library {r['library_ms']:.3f} ms")
            print(f"{k} {r['shape']}: err {r['err']} kernel {r['ms']:.3f} ms "
                  f"plain {r['plain_ms']:.3f} ms bound "
                  f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms{lib}")
    bad = [k for k, rows in rec.items() if any(r["err"] for r in rows)]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    counters = {
        "K1": frontend.decode_front_compact, "K2": engine.place_emit,
        "K3": encode_front.encode_front_compact, "K6": engine.place_fill,
        "K5": compact.compact, "K7": slots.slot_last_writer,
        "K8": scan.tile_scan, "K9": sequential.sequential_decode,
    }
    torch.cuda.reset_peak_memory_stats()
    sqoa_launches, rates = _counted(counters, lambda: main_path(stages, dev))
    # the .qoi path must stay on the card: count the host decodes it makes
    dec_mod = importlib.import_module("seqoia_tpu_torch.codec.decode")
    host, host_calls = dec_mod._host, []
    dec_mod._host = lambda *a: host_calls.append(1) or host(*a)
    try:
        qoi_launches, (qoi_rates, fix) = _counted(
            counters, lambda: qoi_path(qstages, dev))
    finally:
        dec_mod._host = host
    if host_calls:
        raise AssertionError(f"{len(host_calls)} .qoi decodes went to the host")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for path, launches, kernels in (("SQOA", sqoa_launches, SQOA_KERNELS),
                                    (".qoi", qoi_launches, QOI_KERNELS)):
        missing = [k for k in kernels if launches[k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing}")
    launches = {k: sqoa_launches[k] + qoi_launches[k] for k in counters}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for phase, r in rates + qoi_rates:
        print(f"{phase}: {r:.4g} Mpx/s")
    for f in fix:
        print(f"{f['workload']}: fixpoint converged {f['converged']}/"
              f"{f['rows']} rows in {f['passes']} passes; settled "
              f"{f['settled_rows']} rows on the card in {f['settle_passes']} "
              f"more, {f['sequential_rows']} of them by K9; probe: strict "
              f"INDEX-chain depth {f['strict_depth']}, "
              f"predicted {f['predicted_depth']}, {f['index_ops']} INDEX ops")
    print(f"launches on the SQOA path: {sqoa_launches}")
    print(f"launches on the .qoi path: {qoi_launches}")
    print(f"peak device memory of the main paths: {peak_gb:.2f} GiB")
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
            shape=head["shape"]))
    total_s = time.perf_counter() - t_start
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, build_s=build_s, total_s=total_s,
                       kernels=rec, rates=rates + qoi_rates, fixpoint=fix,
                       launches=dict(sqoa=sqoa_launches, qoi=qoi_launches),
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
