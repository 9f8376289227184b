"""Run one cell of the benchmark of ``seqoia_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; ``harness/runner.py`` makes the
inputs from the seed, warms up, measures a closed loop of calls for
``--seconds``, checks the outputs against the plain reference and reads the
cell's metrics: its end-to-end metrics with ``--trace 0``, its per-layer
metrics from a ``torch.profiler`` trace and the benchmark's spans with
``--trace 1``. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

``--control 1`` puts the reference in the program's place, one bit short of
exact (each entry's ``control_call``); its run has to come out not correct.

It runs only on NVIDIA cards, as many as the cell asks for, and exits with
code 2 and no result otherwise, or when JAX or the JAX package was loaded.
The program's kernel builds go to ``seqoia_tpu_torch/_build/`` inside the
checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import manifest, runner

    man = manifest.load_manifest()
    cell, _, _ = manifest.load_cell(man, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        _fail(f"{args.workload} needs {cell['chips']} CUDA card(s), this "
              f"host has {have}; the benchmark runs on no other device")
    result, compared = runner.run(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START,
                                  manifest=man, control=bool(args.control))
    loaded = runner.forbidden_modules()
    if loaded:
        _fail("JAX or the JAX package was loaded: " + ", ".join(loaded))
    for name, value, limit in compared:
        print(f"compared {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
