#!/usr/bin/env python3
"""Run the port on every card of a host, and over the mesh of them all.

    python3 tools/mesh_cards.py [--parent DIR]

Needs two or more NVIDIA GPUs. For each card i, with card 0 the current
device throughout, the public entry points with ``device="cuda:i"``: SQOA
encode and decode of a 1024x1024 RGBA photo (K3, K2, K1), the same as
``.qoi`` (K8, K11, K7, K5, K2), a 2000-link value chain (K9), a mono
``.qoi`` stream (K9's mono step), a REF stream with ``SEQOIA_REF_CUDA=1``
(K10), ``encode_large`` of a 2048x2048 RGB image (K4), ``BatchDecoder``
on 64 icons (K1's segment mode) and K6's fill of one short row, which no
entry point launches: every output equal to the native codec's (K6's to
its plain version),
and every kernel launched while that card ran (the launch counters set to 0
before each card). Then ``chip_smoke.py``'s mesh path at full size over
``default_mesh()``: the 134 Mpx image through the four large-image
functions, and ``BatchDecoder`` / ``BatchEncoder`` on the 32 photos, the
icons and both as ``.qoi``, each without a mesh and with it, byte-equal;
prints their seconds. With ``--parent DIR`` (another checkout, for
example the parent commit unpacked with ``git archive``), first runs that
tree with card 0 current: a SQOA decode on ``cuda:1``, then a REF decode
with ``SEQOIA_REF_CUDA=1`` on ``cuda:0`` and on ``cuda:1``, and prints
whether each ran and matched the native codec. Writes
``chiprun_out/mesh_cards.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# in another tree, card 0 current: a SQOA decode on cuda:1 (K1, K2), then a
# REF decode with SEQOIA_REF_CUDA=1 on cuda:0 and on cuda:1 (K10)
_PARENT = r"""
import os, sys
sys.path.insert(0, ".")
import numpy as np, torch
import seqoia_tpu_torch as st
from seqoia_tpu_torch import native
from seqoia_tpu_torch.utils import corpus
rng = np.random.default_rng(0)
px = corpus._photo(rng, 1024, 1024).reshape(-1)
sqoa = native.encode(px, 1024, 1024, 3, 0, 0)
ref = corpus.ref_sqoa(sqoa, rng)
os.environ["SEQOIA_REF_CUDA"] = "1"
for what, s, dev in (("SQOA decode", sqoa, "cuda:1"),
                     ("REF decode", ref, "cuda:0"),
                     ("REF decode", ref, "cuda:1")):
    try:
        got, _ = st.decode(s, device=dev)
        torch.cuda.synchronize(dev)
        print(f"PARENT {what} ran on {dev}, equal:",
              np.array_equal(got, native.decode(s, 0)[0]))
    except Exception as e:
        print(f"PARENT {what} failed on {dev}:", type(e).__name__,
              str(e)[:200])
"""


def _battery(dev):
    """The entry points on ``dev``; returns {call: seconds}. Raises on an
    output that differs from the native codec's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import engine
    from seqoia_tpu_torch.utils import corpus

    rng = np.random.default_rng(11)
    out = {}

    def run(name, fn, check):
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev)
        out[name] = time.perf_counter() - t
        if not check(got):
            raise AssertionError(f"{name} on {dev} differs from native")

    def pixels_of(stream):
        return lambda got: np.array_equal(got[0], native.decode(stream, 0)[0])

    rgb = corpus._photo(rng, 1024, 1024)
    a = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    photo = np.concatenate([rgb, a], axis=-1).reshape(-1)
    for compat in (0, 1):
        desc = st.SqoaDesc(1024, 1024, 4, 0, compat)
        want = native.encode(photo, 1024, 1024, 4, 0, compat)
        run(f"encode compat={compat}",
            lambda: st.encode(photo, desc, device=dev), want.__eq__)
        run(f"decode compat={compat}",
            lambda: st.decode(want, device=dev), pixels_of(want))
    px, n = cs._value_chain(2000)
    chain = native.encode(px, n, 1, 4, 0, 1)
    run("decode value_chain", lambda: st.decode(chain, device=dev),
        pixels_of(chain))
    mono = corpus.mono_qoi(rng, 512, 512, 2)
    run("decode mono .qoi", lambda: st.decode(mono, device=dev),
        pixels_of(mono))
    ref = corpus.ref_sqoa(native.encode(photo, 1024, 1024, 4, 0, 0), rng)
    os.environ["SEQOIA_REF_CUDA"] = "1"
    try:
        run("decode REF (SEQOIA_REF_CUDA=1)",
            lambda: st.decode(ref, device=dev), pixels_of(ref))
    finally:
        os.environ.pop("SEQOIA_REF_CUDA")
    big = corpus._photo(rng, 2048, 2048).reshape(-1)
    want = native.encode(big, 2048, 2048, 3, 0, 0)
    run("encode_large", lambda: st.encode_large(
        big, st.SqoaDesc(2048, 2048, 3), device=dev), want.__eq__)
    icons = [native.encode(corpus._icon(rng, 64, 5).reshape(-1), 64, 64, 4,
                           0, 0) for _ in range(64)]
    run("BatchDecoder icons", lambda: st.BatchDecoder(device=dev)(icons),
        lambda got: all(np.array_equal(r.pixels, native.decode(s, 0)[0])
                        for r, s in zip(got, icons)))
    keys = torch.tensor([[0, 3, 40, 41, 4000]], dtype=torch.int32)
    pays = torch.tensor([[7, -8, 9, 10, 11]], dtype=torch.int32)
    tot = torch.tensor([4], dtype=torch.int32)
    want = engine._fill_plain(keys, [pays], tot, 4096, (-1,))[0]
    run("place_fill", lambda: engine.place_fill(
        keys.to(dev), [pays.to(dev)], tot.to(dev), 4096, (-1,))[0].cpu(),
        lambda got: torch.equal(got.long(), want))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout to try on cuda:1 first")
    args = ap.parse_args()
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"mesh_cards: needs two or more cards, found {n}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from seqoia_tpu_torch.ops import _build
    from seqoia_tpu_torch.parallel import default_mesh
    from seqoia_tpu_torch.utils import trace

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(smi))
    print(f"os.cpu_count() {os.cpu_count()}")
    report = dict(cards=smi, cpu_count=os.cpu_count())
    if args.parent:
        r = subprocess.run([sys.executable, "-c", _PARENT], cwd=args.parent,
                           capture_output=True, text=True, timeout=600)
        lines = [x for x in r.stdout.splitlines()
                 if x.startswith("PARENT")] or [r.stderr[-600:]]
        print("\n".join(lines))
        report["parent"] = lines
    _build.build_all()
    kernels = ("K1", "K1.seg", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
               "K9", "K9.mono", "K10", "K11")
    report["per_card"] = {}
    for i in range(n):
        dev = torch.device("cuda", i)
        before = trace.counters()
        secs = _battery(dev)
        after = trace.counters()
        launches = {k: after.get("kernels.launches." + k, 0)
                    - before.get("kernels.launches." + k, 0)
                    for k in kernels}
        missing = [k for k, v in launches.items() if not v]
        print(f"cuda:{i} (current device {torch.cuda.current_device()}): "
              f"launches {launches}")
        if missing:
            raise AssertionError(f"cuda:{i}: no launch of {missing}")
        report["per_card"][i] = dict(launches=launches, seconds=secs)

    t = time.perf_counter()
    os.environ["SEQOIA_COMPAT_CUDA"] = "1"
    dev = torch.device("cuda", 0)
    images = cs._images()
    stages = [cs.Stages(*img, dev) for img in images]
    qstages = [cs.Stages(*img, dev, compat=1)
               for img in cs._qoi_images(images)]
    large = cs._large_images(images)
    classes, _, _, icon_px = cs._icon_streams(images, qstages)
    qoi_icons = cs._qoi_icons(icon_px)
    print(f"made the mesh path's inputs in {time.perf_counter() - t:.1f} s")
    mesh = default_mesh()
    rows = cs.mesh_path(large, stages, qstages, classes, icon_px, qoi_icons,
                        mesh, dev)
    print(f"mesh path over default_mesh() ({len(mesh)} cards); seconds "
          "without the mesh, with it:")
    for name, t1, tm in rows:
        print(f"  {name}: {t1:.4f} s, {tm:.4f} s")
    report["mesh_path"] = rows
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mesh_cards.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print("mesh_cards: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
