"""What the tools that time one kernel of this tree against another
checkout's share (``tools/bench_k1.py``, ``bench_k9.py``, ``bench_k10.py``):
the command line, the two libraries, the card's name, the turns and the
output file.

Each tool runs as ``python3 tools/bench_kN.py --parent DIR``, where DIR holds
another checkout of the repository (for example the parent commit unpacked
with ``git archive``), and needs the CUDA toolkit and one card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the order of turns: the parent's timing on both sides of this tree's
ORDER = ("parent", "this tree", "this tree", "parent")


def start(tool: str, doc: str, kernel: str):
    """Parse ``--parent DIR``. Returns (DIR, the first card), or None (with
    a message) when there is no card."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help=f"a checkout whose {kernel} to compare with")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return None
    sys.path.insert(0, ROOT)
    return args.parent, torch.device("cuda", 0)


def libraries(parent: str, module: str, entry: str) -> dict:
    """{label: ctypes library}: DIR's ``csrc/<module>.cu``, built beside
    this tree's and its ``entry`` bound by DIR's own ``_build.py``
    signature, and this tree's as the port builds it."""
    from seqoia_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(parent, "seqoia_tpu_torch", "ops",
                                     "_build.py"))
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    out_dir = os.path.join(_build.BUILD_DIR, f"parent_{module}")
    os.makedirs(out_dir, exist_ok=True)
    proc = _build.compile_shared(
        _build.nvcc_command(os.path.join(parent, "seqoia_tpu_torch", "csrc",
                                         f"{module}.cu")),
        os.path.join(out_dir, "parent.so"))
    this = _build.load(module)
    _build.finish_shared(proc)
    lib = ctypes.CDLL(proc.out_path)
    fn = getattr(lib, entry)
    fn.argtypes = [_build._CTYPES[c]
                   for c in parent_build._SIGNATURES[module][entry]]
    fn.restype = ctypes.c_int
    return {"parent": lib, "this tree": this}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def turns(run, reps: int, check=None, order=ORDER) -> dict:
    """{label: [ms a turn]}: ``run(label)`` timed on the card (the mean of
    ``reps`` calls between CUDA events, after one warm-up) in the turns of
    ``order``, ``check(label)`` after each turn."""
    from chip_smoke import _timed

    ms = {}
    for key in order:
        ms.setdefault(key, []).append(_timed(lambda: run(key), reps))
        if check is not None:
            check(key)
    return ms


def write(name: str, **result) -> None:
    """``chiprun_out/<name>.json`` under the repository's root."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump(result, f, indent=1)
