#!/usr/bin/env python3
"""Time K1 (``seqoia_tpu_torch/csrc/frontend.cu``) against another tree's K1
on one NVIDIA GPU.

    python3 tools/bench_k1.py --parent DIR

DIR holds another checkout of the repository (``tools/_parent_bench.py``).
The script builds DIR's ``frontend.cu`` beside this tree's and calls each
library's ``k1_decode_front`` on the arguments of K1 launches that
``chip_smoke.py``'s paths make:

- ``batch_rgb``: the 32 1024x1024 RGB photos as one batch (mode noalpha,
  ``decode_stream_batched``);
- ``large_rgb``: the 16384x8192 RGB image as ``decode_large`` stages it
  (mode noalpha, one row of 227 MB);
- ``icons_rgb``: 4096 64x64 RGB icons packed as ``BatchDecoder`` packs them
  (mode noalpha, segment mode);
- ``photo_rgba``: the 4096x4096 RGBA photo (mode alpha), a control.

Each shape is timed in turns DIR, this, this, DIR, twice over, each turn the
mean of REPS launches between CUDA events (totals and flags zeroed before
each launch, as the wrapper does), and every output (totals, flags, keys
and payloads below the totals) is held bitwise to DIR's. Prints the card's
name and power limit and one line a shape, and writes
``chiprun_out/bench_k1.json``. Needs the CUDA toolkit and one card.
"""

from __future__ import annotations

import sys

import _parent_bench as pb

REPS = 20
ORDER = pb.ORDER * 2


def _rows(streams, dev):
    """Streams as zero-padded rows (a power of two wide) and their lengths
    less the end marker, on the card."""
    import numpy as np
    import torch

    m = 1 << (max(len(s) for s in streams) - 1).bit_length()
    buf = np.zeros((len(streams), m), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(s, np.uint8)
    clen = torch.tensor([len(s) - 8 for s in streams], dtype=torch.int32)
    return torch.from_numpy(buf).to(dev), clen.to(dev)


def _shapes(dev):
    """[(name, data, chunks_len, n_max, mode, k, seg_px)]."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import pack
    from seqoia_tpu_torch.parallel import batch
    from seqoia_tpu_torch.utils import corpus

    images = cs._images()
    by = {name: (px, w, h, ch) for name, px, w, h, ch in images}
    out = []
    px, w, h, ch = by["batch_rgb"]
    data, clen = _rows([native.encode(p, w, h, ch, 0, 0) for p in px], dev)
    out.append(("batch_rgb", data, clen, cs._pow2(w * h), "noalpha", 1, 0))
    name, px, w, h, ch = cs._large_images(images)[0]
    s = native.encode(px, w, h, ch, 0, 0)
    m = -(-len(s) // pack.TILE) * pack.TILE
    buf = torch.zeros(m, dtype=torch.uint8)
    buf[: len(s)] = torch.frombuffer(bytearray(s), dtype=torch.uint8)
    n_max = -(-w * h // pack.TILE) * pack.TILE
    out.append((name, buf[None].to(dev),
                torch.tensor([len(s) - 8], dtype=torch.int32, device=dev),
                n_max, "noalpha", 1, 0))
    del s, buf
    rng = np.random.default_rng(2)
    icons = [native.encode(np.ascontiguousarray(
        corpus._icon(rng, 64, 5, glow_w=0.6, glow_peak=0.5)[..., :3])
        .reshape(-1), 64, 64, 3, 0, 0) for _ in range(4096)]
    seg = 1 << (max(len(s) for s in icons) - 1).bit_length()
    rows, slens = batch.pack_segments(icons, seg)
    k = rows.shape[1] // seg
    out.append(("icons_rgb", rows.to(dev), slens.to(dev), k * 4096,
                "noalpha", k, 4096))
    px, w, h, ch = by["photo_rgba"]
    data, clen = _rows([native.encode(px[0], w, h, ch, 0, 0)], dev)
    out.append(("photo_rgba", data, clen, cs._pow2(w * h), "alpha", 1, 0))
    return out


def main() -> int:
    started = pb.start("bench_k1", __doc__, "K1")
    if started is None:
        return 2
    parent, dev = started
    import torch

    import chip_smoke as cs
    from seqoia_tpu_torch.ops import _build, frontend

    libs = pb.libraries(parent, "frontend", "k1_decode_front")
    smi = pb.card()
    print(smi)
    rows = []
    for name, data, clen, n_max, mode, k, seg_px in _shapes(dev):
        bsz, m = data.shape
        i32 = dict(dtype=torch.int32, device=dev)
        outs = {key: (torch.empty((bsz, m), **i32),
                      torch.empty((bsz, m), **i32),
                      torch.zeros(bsz, **i32), torch.zeros(bsz, **i32),
                      torch.empty(frontend.scratch_words(bsz, m, k), **i32))
                for key in libs}

        def run(key):
            keys, pays, tot, ref, scratch = outs[key]
            tot.zero_()
            ref.zero_()
            P = _build.ptr
            _build.launch(libs[key], "k1_decode_front", dev, P(data),
                          P(clen), bsz, m, int(n_max),
                          frontend.MODES[mode], k, seg_px, P(scratch),
                          P(keys), P(pays), P(tot), P(ref))

        ms = pb.turns(run, REPS, order=ORDER)
        want = cs._front_view(outs["parent"][:4])
        if not all(torch.equal(a, b) for a, b in
                   zip(cs._front_view(outs["this tree"][:4]), want)):
            raise AssertionError(f"{name}: this tree's K1 differs from the "
                                 "parent's")
        nbytes = int(clen.sum()) + 4 * clen.numel() + 8 * int(
            outs["parent"][2].sum()) + 8 * bsz
        row = dict(shape=name, rows=bsz, m=m, mode=mode, k=k,
                   bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   has_ref=int(outs["parent"][3].sum()), ms=ms)
        rows.append(row)
        print(f"K1 {name} ({bsz}, {m}) {mode}" + (f" seg={m // k}" if k > 1
                                                   else "")
              + f", bound {row['bound_ms']:.4f} ms: " + "; ".join(
                  f"{key} {sum(v) / len(v):.4f} ms ("
                  + ", ".join(f"{x:.4f}" for x in v) + ")"
                  for key, v in ms.items()) + ", outputs equal")
        del outs, data, clen
        torch.cuda.empty_cache()
    pb.write("bench_k1", card=smi, reps=REPS, order=ORDER, shapes=rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
