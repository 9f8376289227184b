"""K5: order-preserving compaction of a key stream and its payloads.

Port of ``seqoia_tpu/ops/pallas_engine.py:compact``. The kernel is
``csrc/compact.cu`` (one launch: count each tile's kept entries, take the
tile's output base by a decoupled look-back, write its run as contiguous
stores; see its header for what bounds it on the H100); ``compact_plain`` is
the same function in plain PyTorch. The Pallas kernel returns (B, M +
slack) streams; the port's are (B, M), and ``convert.compact`` turns the
one layout into the other. Either way only the entries below ``totals``
are defined: the kernel does not write past them, the plain version
leaves zeros there.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from ._plain import compact_rows
from .scan import scratch_words


def compact_plain(valid, key, payloads):
    """Plain PyTorch K5 (see ``compact``)."""
    keys_c, *pays_c = compact_rows(valid, key, *payloads)
    return keys_c, pays_c, valid.sum(dim=-1).to(torch.int32)


def compact(valid, key, payloads):
    """K5. valid: (B, M) bool (or 0/1 integers); key and 1-2 payloads: (B,
    M) int32. Returns (keys (B, M), [payloads (B, M)], totals (B,) int32):
    the entries where ``valid`` holds, in order, at the front of each row.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    payloads = list(payloads)
    if key.dim() != 2 or key.dtype != torch.int32:
        raise ValueError("key must be a (B, M) int32 tensor")
    if valid.shape != key.shape:
        raise ValueError("valid must match key: (B, M)")
    for p in payloads:
        if p.shape != key.shape or p.dtype != torch.int32:
            raise ValueError("payloads must match key: (B, M) int32")
    if not 1 <= len(payloads) <= 2:
        raise ValueError("compact takes 1 or 2 payload streams")
    if valid.dtype != torch.bool:
        valid = valid != 0
    if not key.is_cuda:
        if key.device.type != "cpu":
            raise ValueError(f"unsupported device {key.device}")
        return compact_plain(valid, key, payloads)
    bsz, m = key.shape
    dev = key.device
    i32 = dict(dtype=torch.int32, device=dev)
    ins = [key.contiguous()] + [p.contiguous() for p in payloads]
    outs = [torch.empty((bsz, m), **i32) for _ in ins]
    ins, outs = ins + [None] * (3 - len(ins)), outs + [None] * (3 - len(outs))
    totals = torch.empty(bsz, **i32)
    scratch = torch.empty(scratch_words(bsz, m), **i32)
    P = _build.ptr
    trace.count("kernels.launches.K5")
    _build.launch(
        "compact", "k5_compact", dev,
        P(valid.contiguous().view(torch.uint8)), P(ins[0]), P(ins[1]),
        P(ins[2]), bsz, m, P(scratch), P(outs[0]), P(outs[1]), P(outs[2]),
        P(totals))
    return outs[0], [o for o in outs[1:] if o is not None], totals
