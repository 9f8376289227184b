#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seqoia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every kernel of the main path from ``seqoia_tpu_torch/csrc``
   (one nvcc per source, all at once).
2. Holds each kernel (K1 decode front, K2 placement with its decode and
   encode epilogues, K3 encode front, K6 placement fill) against its plain
   PyTorch version on the card, on the inputs the main path gives it:
   integer data, so the comparison is bit-exact (tolerance 0).
3. Resets the kernels' launch counters and drives the main path through
   the public entry points: one 4096x4096 RGBA photo-class image, a batch
   of 32 1024x1024 RGB photos (decode_stream_batched /
   encode_stream_batched) and one 2048x2048 gray+alpha image (decoded as
   stored and with 4 forced channels). Every stream and every pixel is
   held byte-exact against the port's native C codec. Fails if a kernel
   of the path was not launched, or if the main path's encode caps are not
   the ones K2's encode epilogue was checked and timed at.
4. Prints the card's name and power limit, each phase's Mpx/s, each
   kernel's time beside its bound, a JSON ``kernels`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero; without a CUDA device it exits 2 and prints
no result. Images are synthetic and made from a fixed seed. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
}


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


def _max_err(a, b) -> int:
    """Max |a - b| over integer tensors; a shape mismatch fails."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


class Stages:
    """One workload's inputs on the card and its stage outputs."""

    def __init__(self, name, pixels, w, h, ch, dev):
        import torch

        import seqoia_tpu_torch as st
        from seqoia_tpu_torch import native, spec
        from seqoia_tpu_torch.codec import normalize_pixels_packed
        from seqoia_tpu_torch.codec.encode import first_cap, pixel_bucket

        self.name, self.w, self.h, self.ch = name, w, h, ch
        self.pixels = pixels
        self.desc = st.SqoaDesc(w, h, ch, 0, 0)
        self.streams = [native.encode(p, w, h, ch) for p in pixels]
        self.n = w * h
        self.colch = self.desc.col_channels
        self.mode = ("mono" if self.colch == 1 else
                     ("alpha" if self.desc.has_alpha else "noalpha"))
        self.out_ch = self.desc.norm_channels
        self.n_max = _pow2(self.n)
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
        # first call per (colch, has_alpha) uses: K2's encode shape
        n_pad = pixel_bucket(self.n)
        packed = np.zeros((len(pixels), n_pad), np.int32)
        for i, p in enumerate(pixels):
            packed[i, : self.n] = normalize_pixels_packed(p, self.desc)
        self.packed_host = packed
        self.packed = torch.from_numpy(packed).to(dev)
        self.out_cap = first_cap(self.desc, n_pad)


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

    def clock(phase, n_px, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rates.append((phase, n_px / (time.perf_counter() - t) / 1e6))
        return out

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from seqoia_tpu_torch.ops import (_build, encode_front, engine,
                                          frontend)
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"built {sorted(logs)} in {build_s:.1f} s")

    t0 = time.perf_counter()
    stages = [Stages(*img, dev) for img in _images()]
    print(f"made and encoded (native) the inputs in "
          f"{time.perf_counter() - t0:.1f} s")

    rec = check_kernels(stages, dev)
    for k, rows in rec.items():
        for r in rows:
            print(f"{k} {r['shape']}: err {r['err']} kernel {r['ms']:.3f} ms "
                  f"plain {r['plain_ms']:.3f} ms bound "
                  f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    bad = [k for k, rows in rec.items() if any(r["err"] for r in rows)]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    counters = {
        "K1": frontend.decode_front_compact, "K2": engine.place_emit,
        "K3": encode_front.encode_front_compact, "K6": engine.place_fill,
    }
    for fn in counters.values():
        fn.launches = 0
    rates = main_path(stages, dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for phase, r in rates:
        print(f"{phase}: {r:.1f} Mpx/s")
    print(f"launches on the main path: {launches}")
    kernels = []
    for k, (fname, src, repl) in KERNELS.items():
        first = rec[k][0]
        kernels.append(dict(
            name=f"{k} {fname}", route="cuda", source=src, replaces=repl,
            launches=launches[k],
            max_abs_err=max(r["err"] for r in rec[k]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None, shape=first["shape"]))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, build_s=build_s, kernels=rec, rates=rates,
                       launches=launches), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
