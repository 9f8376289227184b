#!/usr/bin/env python3
"""Time K9 (``seqoia_tpu_torch/csrc/sequential.cu``) against another tree's
K9 on one NVIDIA GPU.

    python3 tools/bench_k9.py --parent DIR

DIR holds another checkout of the repository (``tools/_parent_bench.py``).
The script builds DIR's
``seqoia_tpu_torch/csrc/sequential.cu`` beside this tree's, and records the
K9 launches of
``chip_smoke.py``'s mono path (the 4096x4096 stream's ``decode`` and the
BatchDecoder classes of its 64 1024x1024 mono streams) and of its value
chain's ``decode``, and one class of 2048 rows of 64x64 mono streams (no
path launches it: many short rows). Each launch is timed by CUDA events
with both libraries in the order DIR, this, this, DIR, every output held
bitwise to DIR's. Then the mono path end to end (host clock, ended by a
synchronize: the 4096x4096 ``decode`` and the BatchDecoder call) in the
same order. Prints one line a launch and library, and writes
``chiprun_out/bench_k9.json``. Needs the CUDA toolkit and one card.
"""

from __future__ import annotations

import sys
import time

import _parent_bench as pb


def _record(run):
    """The arguments (lo, hi, totals, colch) of every K9 launch of run()."""
    from seqoia_tpu_torch.ops import sequential

    seen, fn = [], sequential.sequential_decode

    def rec(lo, hi, tot, colch=3):
        seen.append((lo, hi, tot, colch))
        return fn(lo, hi, tot, colch)

    sequential.sequential_decode = rec
    try:
        run()
    finally:
        sequential.sequential_decode = fn
    return seen


def _launch(lib, args, dev):
    """One K9 launch through ``lib``: its output."""
    import torch

    from seqoia_tpu_torch.ops import _build

    lo, hi, tot, colch = args
    out = torch.zeros_like(lo)
    P = _build.ptr
    _build.launch(
        lib, "k9_sequential_decode", dev,
        P(lo.contiguous()), P(None if hi is None else hi.contiguous()),
        P(tot.to(torch.int32).contiguous()), lo.shape[0], lo.shape[1], colch,
        P(out))
    return out


def main() -> int:
    started = pb.start("bench_k9", __doc__, "K9")
    if started is None:
        return 2
    parent, dev = started
    import numpy as np
    import torch

    import chip_smoke as cs
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native
    from seqoia_tpu_torch.ops import _build
    from seqoia_tpu_torch.utils import corpus

    libs = pb.libraries(parent, "sequential", "k9_sequential_decode")
    big, mixed = cs._mono_streams([None] * 32)
    mono = [x for x in mixed if x is not None]
    px, n = cs._value_chain(2000)
    chain = native.encode(px, n, 1, 4, 0, 1)
    launches = [("mono 4096x4096 decode", a) for a in _record(
        lambda: st.decode(big, device=dev))]
    launches += [("mono BatchDecoder class", a) for a in _record(
        lambda: st.BatchDecoder(device=dev)(mono))]
    launches += [("value_chain decode", a) for a in _record(
        lambda: st.decode(chain, device=dev))]
    rng = np.random.default_rng(7)
    lo, tot = cs._mono_ops([corpus.mono_qoi(rng, 64, 64, 1 + i % 2)
                            for i in range(2048)], dev)
    launches.append(("2048 mono rows of 64x64, off the path",
                     (lo, None, tot, 1)))

    smi = pb.card()
    load_ns, load_cycles = cs.smem_load_ns(dev)
    print(smi)
    print(f"one dependent shared-memory load: {load_ns:.4f} ns, "
          f"{load_cycles:.2f} SM cycles")
    rows = []
    for what, a in launches:
        lo, _, tot, colch = a
        longest = min(int(tot.max()), lo.shape[1])
        reps = 3 if longest > 100_000 else 10
        want = _launch(libs["parent"], a, dev)

        def check(k):
            if not torch.equal(_launch(libs[k], a, dev), want):
                raise AssertionError(f"{what}: {k} differs from the parent")
        ms = pb.turns(lambda k: _launch(libs[k], a, dev), reps, check)
        for k, v in ms.items():
            mean = sum(v) / len(v)
            rows.append(dict(launch=what, shape=tuple(lo.shape), colch=colch,
                             longest=longest, lib=k, ms=mean, runs_ms=v,
                             ns_per_op=mean * 1e6 / longest,
                             chain_bound_ms=longest * load_ns * 1e-6))
            print(f"{what} {tuple(lo.shape)} longest={longest} {k}: "
                  f"{mean:.4f} ms ({v[0]:.4f}, {v[1]:.4f}), "
                  f"{mean * 1e6 / longest:.2f} ns an op")

    e2e = []
    for k in pb.ORDER:
        _build._libs["sequential"] = libs[k]
        for what, n_px, run in (
                ("mono .qoi 4096x4096 decode", 4096 * 4096,
                 lambda: st.decode(big, device=dev)),
                (f"mono .qoi BatchDecoder ({len(mono)} x 1024x1024)",
                 len(mono) * 1024 * 1024,
                 lambda: st.BatchDecoder(device=dev)(mono))):
            run()
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rate = n_px / (time.perf_counter() - t) / 1e6
            e2e.append(dict(lib=k, what=what, mpx_s=rate))
            print(f"{what} with {k}: {rate:.2f} Mpx/s")
    _build._libs.pop("sequential")

    pb.write("bench_k9", card=smi, smem_load_ns=load_ns,
             smem_load_cycles=load_cycles, launches=rows, end_to_end=e2e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
