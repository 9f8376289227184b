#!/usr/bin/env python3
"""Time the small kernel launches of this tree against another tree's on one
NVIDIA GPU: the host's cost a launch, where ``ops/_build.py`` calls the C
entry points.

    python3 tools/bench_launch.py --parent DIR

DIR holds another checkout of the repository (for example the parent commit
unpacked with ``git archive``). Each turn runs, in a process of its own
started in one tree, ``cli fuzz 1000 --cuda`` (6000 decodes of 0-150 byte
streams: small launches of K1, K2 and K5-K8, where the host's loop sets the
pace) under that tree's ``chip_smoke._census``, which times every launch on
the card by CUDA events around its C entry point; the turn prints each
kernel's launches and mean ms a launch, and the fuzz's seconds on the host
clock (the whole run, the launch path's host work included). Turns go
DIR, this, this, DIR. Prints one line a kernel and turn, and writes
``chiprun_out/bench_launch.json``. Needs the CUDA toolkit and one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("K1", "K2", "K5", "K6", "K7", "K8")

# one turn, run in a tree: its census of the fuzz, as one JSON line
_TURN = r"""
import contextlib, io, json, sys, time
sys.path.insert(0, ".")
import chip_smoke as cs
from seqoia_tpu_torch import cli
from seqoia_tpu_torch.ops import _build

_build.build_all()
cli.main(["fuzz", "50", "--cuda"])  # warm-up
t = time.perf_counter()
with contextlib.redirect_stdout(io.StringIO()):
    table, rc = cs._census(lambda: cli.main(["fuzz", "1000", "--cuda"]))
secs = time.perf_counter() - t
out = {"rc": rc, "fuzz_s": secs}
for kid, shapes in table.items():
    out[kid] = [sum(r[0] for r in shapes.values()),
                sum(r[1] for r in shapes.values())]
print("TURN " + json.dumps(out))
"""


def _turn(tree: str) -> dict:
    env = dict(os.environ, SEQOIA_REF_CUDA="")
    r = subprocess.run([sys.executable, "-c", _TURN], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=900)
    line = next((x for x in r.stdout.splitlines() if x.startswith("TURN ")),
                None)
    if r.returncode != 0 or line is None:
        raise RuntimeError(f"the turn in {tree} failed:\n{r.stderr[-3000:]}")
    out = json.loads(line[5:])
    if out["rc"] != 0:
        raise RuntimeError(f"the fuzz in {tree} found a mismatch")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose launches to compare with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_launch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    trees = {"parent": os.path.abspath(args.parent), "this tree": ROOT}
    turns = []
    for label in ("parent", "this tree", "this tree", "parent"):
        t = _turn(trees[label])
        turns.append(dict(tree=label, **t))
        print(f"{label}: fuzz {t['fuzz_s']:.3f} s; " + "; ".join(
            f"{k} {t[k][0]} launches {t[k][1] / max(t[k][0], 1):.5f} ms"
            for k in KERNELS if k in t))
    for k in KERNELS:
        per = {}
        for t in turns:
            if k in t:
                per.setdefault(t["tree"], []).append(
                    t[k][1] / max(t[k][0], 1))
        print(f"{k} ms a launch: " + "; ".join(
            f"{lab} {', '.join(f'{v:.5f}' for v in vs)}"
            for lab, vs in per.items()))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_launch.json"),
              "w") as f:
        json.dump(dict(card=smi, turns=turns), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
