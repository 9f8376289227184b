"""seqoia_tpu_torch command line tools (``seqoia_tpu/cli.py``).

    python -m seqoia_tpu_torch.cli convert input.png output.sqoa
    python -m seqoia_tpu_torch.cli bench [flags] <directory> [runs]
    python -m seqoia_tpu_torch.cli corpus <directory>   # synthesize bench corpus
    python -m seqoia_tpu_torch.cli fuzz [iterations]

`convert` mirrors the reference converter (reference: sqoaconv.c:38-100):
the output format follows the file extension, `.qoi` selects QOI-compatible
mode, and odd-channel PNG inputs are forced to even channel counts.
`bench` mirrors sqoabench's flags and table (reference: sqoabench.c:301-684).
The card path runs on `--device` (default `cuda`); `--device cpu` runs the
same pipeline through the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cmd_convert(args) -> int:
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch.io import png as pngio

    inp, out = args.input, args.output
    ext_in = os.path.splitext(inp)[1].lower()
    ext_out = os.path.splitext(out)[1].lower()
    backend = "native" if args.native else "cuda"

    if ext_in in (".png", ".jpg", ".jpeg"):
        pixels, w, h, ch = pngio.read_image(inp)
        if ch % 2 == 1 and ext_out in (".sqoa", ".qoi"):
            # odd channel counts get an opaque alpha plane appended
            # (reference: sqoaconv.c:56-59)
            wide = np.full((w * h, ch + 1), 255, np.uint8)
            wide[:, :ch] = pixels.reshape(-1, ch)
            pixels, ch = wide.reshape(-1), ch + 1
    elif ext_in in (".sqoa", ".qoi"):
        pixels, desc = st.read(inp, 0, backend=backend, device=args.device)
        if pixels is None:
            print(f"error: could not decode {inp}", file=sys.stderr)
            return 1
        w, h = desc.width, desc.height
        ch = desc.norm_channels
    else:
        print(f"error: unsupported input format {ext_in}", file=sys.stderr)
        return 1

    if ext_out in (".png", ".jpg", ".jpeg"):
        pngio.write_image(out, pixels, w, h, ch, quality=args.quality)
    elif ext_out in (".sqoa", ".qoi"):
        desc = st.SqoaDesc(w, h, ch, 0, 1 if ext_out == ".qoi" else 0)
        n = st.write(out, pixels, desc, backend=backend, device=args.device)
        if n == 0:
            print(f"error: could not encode {out}", file=sys.stderr)
            return 1
    else:
        print(f"error: unsupported output format {ext_out}", file=sys.stderr)
        return 1
    print(f"{inp} -> {out} ({w}x{h}, {ch} channels)")
    return 0


def _cmd_bench(args) -> int:
    from seqoia_tpu_torch.utils import bench_harness

    opts = {
        k: getattr(args, k)
        for k in ("nowarmup", "nopng", "noverify", "noencode", "nodecode",
                  "norecurse", "noaverage", "onlytotals")
    }
    bench_harness.bench_directory(
        args.directory, runs=args.runs, opts=opts, use_cuda=args.cuda,
        device=args.device,
    )
    return 0


def _cmd_corpus(args) -> int:
    from seqoia_tpu_torch.io import png as pngio
    from seqoia_tpu_torch.utils import make_corpus

    os.makedirs(args.directory, exist_ok=True)
    for i, (pixels, w, h, ch) in enumerate(make_corpus(args.scale)):
        path = os.path.join(args.directory, f"img_{i:03d}.png")
        pngio.write_image(path, pixels, w, h, ch)
    print(f"wrote synthetic corpus to {args.directory}")
    return 0


def _cmd_fuzz(args) -> int:
    """Decode fuzzing: random + mutated streams through both backends,
    cross-checked (the framework's analogue of sqoafuzz.c)."""
    import seqoia_tpu_torch as st
    from seqoia_tpu_torch import native, spec

    rng = np.random.default_rng(args.seed)
    checked = 0
    for trial in range(args.iterations):
        kind = trial % 3
        if kind == 0:
            w, h = int(rng.integers(1, 24)), int(rng.integers(1, 24))
            compat = int(rng.integers(0, 2))
            pix = rng.integers(0, 256, w * h * 4, dtype=np.uint8)
            s = bytearray(native.encode(pix, w, h, 4, 0, compat))
            for _ in range(int(rng.integers(1, 6))):
                s[int(rng.integers(14, len(s)))] = int(rng.integers(0, 256))
            data = bytes(s)
        elif kind == 1:
            d = spec.SqoaDesc(
                int(rng.integers(1, 12)), int(rng.integers(1, 12)),
                int(rng.integers(3, 5)), 0, int(rng.integers(0, 2)),
            )
            data = (
                spec.pack_header(d)
                + bytes(rng.integers(0, 256, int(rng.integers(0, 150))).astype(np.uint8))
                + spec.PADDING
            )
        else:
            data = bytes(rng.integers(0, 256, int(rng.integers(0, 100))).astype(np.uint8))
        for fch in (0, 3, 4):
            pn, dn = native.decode(data, fch)
            if args.cuda:
                pt, dt = st.decode(data, fch, backend="cuda",
                                   device=args.device)
                ok_n, ok_t = pn is not None, pt is not None
                if ok_n != ok_t or (ok_n and not np.array_equal(pn, pt)):
                    print(f"MISMATCH at trial {trial} fch={fch}")
                    return 1
            if pn is not None:
                checked += 1
    print(f"fuzz: {args.iterations} streams, {checked} decoded, 0 mismatches")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seqoia_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device of the card path (cpu runs the "
                             "kernels' plain versions)")

    c = sub.add_parser("convert", parents=[device],
                       help="convert between png/jpg/qoi/sqoa")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--native", action="store_true",
                   help="use the host C runtime instead of the card path")
    c.add_argument("--quality", type=int, default=90, help="jpeg quality")
    c.set_defaults(fn=_cmd_convert)

    b = sub.add_parser("bench", parents=[device],
                       help="sqoabench-style directory benchmark")
    b.add_argument("directory")
    b.add_argument("runs", type=int, nargs="?", default=3)
    for flag in ("nowarmup", "nopng", "noverify", "noencode", "nodecode",
                 "norecurse", "noaverage", "onlytotals"):
        b.add_argument(f"--{flag}", action="store_true")
    b.add_argument("--cuda", action="store_true",
                   help="also bench the card path per image")
    b.set_defaults(fn=_cmd_bench)

    g = sub.add_parser("corpus", help="generate the synthetic bench corpus")
    g.add_argument("directory")
    g.add_argument("--scale", type=float, default=1.0)
    g.set_defaults(fn=_cmd_corpus)

    f = sub.add_parser("fuzz", parents=[device],
                       help="decoder fuzzing (native vs the card path)")
    f.add_argument("iterations", type=int, nargs="?", default=500)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--cuda", action="store_true")
    f.set_defaults(fn=_cmd_fuzz)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
