"""Scan helpers of the compat paths that add logic to K8.

Port of the parts of ``seqoia_tpu/ops/scan_ops.py`` that are more than a
call of one K8 combine: the paths call the K8 wrappers (``ops/scan.py``:
``cummax`` for ``hillis_max``, ``segmented_modsum``, ``compose_state_maps``,
``fill_forward``) directly. Every scan runs along the last axis of a (B, M)
int32 tensor. ``blocked_cumsum`` is ``torch.cumsum``: the JAX package
computes it in XLA (triangular matmuls on the MXU), not in a Pallas kernel.
"""

from __future__ import annotations

import torch

from . import scan
from ._plain import to_i32


def blocked_cumsum(x):
    """Exact inclusive int32 prefix sum (wrapping like int32)."""
    return to_i32(torch.cumsum(x, dim=-1, dtype=torch.int64))


def pack_pair(v0, f0, v1, f1):
    """Two (value mod 256, reset flag) channels in one int32: bits 0-7
    value0, bit 8 flag0, bits 16-23 value1, bit 24 flag1: the words of
    ``scan.segmented_modsum``."""
    return ((v0 & 255) | (f0.to(torch.int32) << 8) | ((v1 & 255) << 16)
            | (f1.to(torch.int32) << 24))


def pack_state_map(next_for_zero):
    """Per-element 5-state map m with m[0] = next_for_zero and m[e] = e - 1
    for e > 0: the tokenizer's countdown (a boundary becomes len - 1)."""
    return next_for_zero + ((0 << 3) | (1 << 6) | (2 << 9) | (3 << 12))


def tokenizer_states(lens, start: int):
    """Countdown state before each position, from per-position token
    lengths (1-5); positions before ``start`` count as 1-byte tokens, so
    the state at ``start`` is 0. Returns int32 states in 0..4."""
    idx = torch.arange(lens.shape[-1], device=lens.device)
    eff = torch.where(idx >= start, lens, 1).to(torch.int32)
    applied = scan.compose_state_maps(pack_state_map(eff - 1)) & 7
    return torch.cat([torch.zeros_like(applied[..., :1]), applied[..., :-1]],
                     dim=-1)
