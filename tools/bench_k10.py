#!/usr/bin/env python3
"""Time K10 (``seqoia_tpu_torch/csrc/ref.cu``) against another tree's K10 on
one NVIDIA GPU.

    python3 tools/bench_k10.py --parent DIR

DIR holds another checkout of the repository (``tools/_parent_bench.py``).
The script builds DIR's
``seqoia_tpu_torch/csrc/ref.cu`` beside this tree's and calls each
library's C entry point with the arguments its tree's ``_build.py``
declares (the scratch of records that this tree's design takes is passed
only to a library that declares it). Four groups of launches, as
``chip_smoke.py`` makes them:

- the 2048x2048 gray+alpha stream and the 4096x4096 RGBA photo's, REF
  spliced in (``chip_smoke._ref_inputs``), one launch each;
- the 64 64x64 streams of the REF maker at channels 0-4 (320 launches);
- the launches that ``cli fuzz 1000 --cuda`` makes with SEQOIA_REF_CUDA=1
  (recorded from the wrapper; streams of 0-150 bytes).

Each group is timed by CUDA events around its launches, the libraries in
the order DIR, this, this, DIR, and every output (pixels, err, ops walked)
is held bitwise to DIR's. The small groups are also captured into a CUDA
graph a library and replayed in the same order: the card's time a launch
without the host's launch loop, which paces launches this short. Then
``decode`` with SEQOIA_REF_CUDA=1 (this tree) and ``native.decode`` on the
two full-size streams, host clock ended by a synchronize. Prints one line a group and library, and writes
``chiprun_out/bench_k10.json``. Needs the CUDA toolkit and one card.
"""

from __future__ import annotations

import os
import sys
import time
import types

import _parent_bench as pb


class _Launch:
    """One K10 launch's arguments and, for each library, its outputs."""

    def __init__(self, args, dev):
        import torch

        (self.data, self.clen, self.n, self.colch, self.out_ch,
         self.n_max) = args
        self.rec = torch.empty(2 * (self.n + 1), dtype=torch.int32,
                               device=dev)
        self.out, self.stat, self.args = {}, {}, {}

    def run(self, key, lib, with_rec, dev):
        """One launch through lib; its arguments are made once a library
        and stream, so that the host's loop costs both libraries alike."""
        import torch

        from seqoia_tpu_torch.ops import _build

        stream = torch.cuda.current_stream(dev).cuda_stream
        if (key, stream) not in self.args:
            if key not in self.out:
                self.out[key] = torch.zeros(self.n_max * self.out_ch,
                                            dtype=torch.uint8, device=dev)
                self.stat[key] = torch.zeros(4, dtype=torch.int32,
                                             device=dev)
            P = _build.ptr
            self.args[key, stream] = (
                P(self.data), self.data.numel(), self.clen, self.n,
                self.colch, self.out_ch, P(self.out[key]),
                *((P(self.rec),) if with_rec else ()), P(self.stat[key]))
        _build.launch(lib, "k10_ref_decode", dev, *self.args[key, stream])

    def result(self, key):
        s = self.stat[key].cpu()
        return self.out[key], bool(s[0]), int(s[1]), int(s[3])


def _fuzz_launches(dev):
    """The arguments of every K10 launch of ``cli fuzz 1000 --cuda`` with
    SEQOIA_REF_CUDA=1."""
    from seqoia_tpu_torch import cli
    from seqoia_tpu_torch.ops import ref

    seen, fn = [], ref.ref_decode

    def rec(data, chunks_len, n_pixels, *, colch, out_ch, n_max):
        seen.append((data.clone(), chunks_len, n_pixels, colch, out_ch,
                     n_max))
        return fn(data, chunks_len, n_pixels, colch=colch, out_ch=out_ch,
                  n_max=n_max)

    old = os.environ.get("SEQOIA_REF_CUDA")
    os.environ["SEQOIA_REF_CUDA"] = "1"
    ref.ref_decode = rec
    try:
        if cli.main(["fuzz", "1000", "--cuda"]) != 0:
            raise AssertionError("fuzz --cuda found mismatches")
    finally:
        ref.ref_decode = fn
        if old is None:
            del os.environ["SEQOIA_REF_CUDA"]
        else:
            os.environ["SEQOIA_REF_CUDA"] = old
    return seen


def main() -> int:
    started = pb.start("bench_k10", __doc__, "K10")
    if started is None:
        return 2
    parent, dev = started
    import torch

    import chip_smoke as cs
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native

    libs = pb.libraries(parent, "ref", "k10_ref_decode")
    # a library takes the records' scratch where its tree declares it
    libs = {k: (lib, len(lib.k10_ref_decode.argtypes) == len(
        libs["this tree"].k10_ref_decode.argtypes))
        for k, lib in libs.items()}
    stages = [types.SimpleNamespace(name=name, streams=[native.encode(
        px[0], w, h, ch, 0, 0)]) for name, px, w, h, ch in cs._images()]
    small, big = cs._ref_inputs(stages)
    groups = [(name, [_Launch(cs._ref_args(s, 0, dev), dev)])
              for name, s, _ in big]
    groups.append(("64 maker 64x64 streams at channels 0-4", [
        _Launch(cs._ref_args(s, c, dev), dev)
        for where, s in small if where == "maker 64x64" for c in range(5)]))
    groups.append(("cli fuzz 1000 --cuda, SEQOIA_REF_CUDA=1",
                   [_Launch(a, dev) for a in _fuzz_launches(dev)]))

    smi = pb.card()
    load_ns, load_cycles = cs.smem_load_ns(dev)
    print(smi)
    print(f"one dependent shared-memory load: {load_ns:.4f} ns, "
          f"{load_cycles:.2f} SM cycles")
    rows = []
    for what, launches in groups:
        for L in launches:  # the parent's outputs: the ones to hold to
            L.run("parent", *libs["parent"], dev)
        want = [L.result("parent")[:3] for L in launches]
        big_group = max(L.n for L in launches) > 1 << 20
        reps = 1 if big_group else 5

        def run(k):
            for L in launches:
                L.run(k, *libs[k], dev)

        def check(k):
            for L, (wpx, werr, wops) in zip(launches, want):
                px, err, ops, fault = L.result(k)
                if (not torch.equal(px, wpx) or err != werr or ops != wops
                        or k != "parent" and fault):
                    raise AssertionError(f"{what}: {k} differs from the "
                                         f"parent (fault word {fault})")
        ms = {k: [x / len(launches) for x in v]
              for k, v in pb.turns(run, reps, check).items()}
        graph = {k: [] for k in libs}
        if not big_group:
            graphs = {}
            for k in libs:
                graphs[k] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[k]):
                    run(k)
            graph = {k: [x / len(launches) for x in v] for k, v in pb.turns(
                lambda k: graphs[k].replay(), 5).items()}
            for L, (wpx, werr, wops) in zip(launches, want):
                px, err, ops_, _ = L.result("this tree")
                if not torch.equal(px, wpx) or err != werr or ops_ != wops:
                    raise AssertionError(f"{what}: the replayed graph "
                                         "differs from the parent")
        ops = sum(w[2] for w in want)
        for k, v in ms.items():
            mean = sum(v) / len(v)
            g = sum(graph[k]) / len(graph[k]) if graph[k] else None
            rows.append(dict(group=what, launches=len(launches), lib=k,
                             ms_per_launch=mean, runs_ms=v,
                             graph_ms_per_launch=g, graph_runs_ms=graph[k],
                             ops=ops,
                             ns_per_op=mean * len(launches) * 1e6
                             / max(ops, 1),
                             chain_bound_ms=ops * load_ns * 1e-6
                             / len(launches)))
            print(f"{what} ({len(launches)} launches, {ops} ops) {k}: "
                  f"{mean:.4f} ms a launch ({', '.join(f'{x:.4f}' for x in v)}), "
                  f"{rows[-1]['ns_per_op']:.2f} ns an op, chain bound "
                  f"{rows[-1]['chain_bound_ms']:.4f} ms a launch"
                  + ("" if g is None else
                     f"; from a CUDA graph {g:.4f} ms a launch "
                     f"({', '.join(f'{x:.4f}' for x in graph[k])})"))
        del launches

    e2e = []
    os.environ["SEQOIA_REF_CUDA"] = "1"
    for name, stream, _ in big:
        desc = st.spec.unpack_header(stream[:15] + bytes(8))
        for channels in (0, 4):
            for what, run in (
                    ("decode (this tree, SEQOIA_REF_CUDA=1)",
                     lambda: st.decode(stream, channels, device=dev)),
                    ("native.decode (the host)",
                     lambda: native.decode(stream, channels))):
                run()
                torch.cuda.synchronize()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                rate = desc.n_pixels / (time.perf_counter() - t) / 1e6
                e2e.append(dict(stream=name, channels=channels, what=what,
                                mpx_s=rate))
                print(f"{name} channels={channels} {what}: {rate:.2f} Mpx/s")

    pb.write("bench_k10", card=smi, smem_load_ns=load_ns,
             smem_load_cycles=load_cycles, groups=rows, end_to_end=e2e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
