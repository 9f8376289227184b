"""Helpers for the plain PyTorch versions of the kernels.

The plain versions compute in int64, so every 32-bit word (packed pixels,
the SWAR channel sums, meta words) is an exact non-negative value and no
shift or mask has to worry about sign extension; ``to_i32`` wraps the
result back to the int32 bit pattern the kernels produce.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., i + k] along the last axis, 0 past the end."""
    if k == 0:
        return x
    out = torch.zeros_like(x)
    out[..., :-k] = x[..., k:]
    return out


def hillis_steele(elems, combine):
    """Inclusive scan along the last axis by log-step doubling.

    elems: tuple of same-shape tensors (one scan element per position);
    combine(left, right) -> tuple, associative, applied left then right."""
    elems = tuple(elems)
    n = elems[0].shape[-1]
    d = 1
    while d < n:
        left = tuple(e[..., :-d] for e in elems)
        right = tuple(e[..., d:] for e in elems)
        comb = combine(left, right)
        elems = tuple(
            torch.cat([e[..., :d], c], dim=-1) for e, c in zip(elems, comb)
        )
        d *= 2
    return elems


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the int32 with that pattern."""
    x = x & U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def compact_rows(mask: torch.Tensor, *streams: torch.Tensor):
    """Order-preserving compaction per row: entries where ``mask`` holds
    move to the front, the rest of each (B, M) int32 output is 0 (one
    scatter for all rows: an entry goes to its row's count of kept entries
    before it)."""
    mask = mask.to(torch.bool)
    rows = torch.arange(mask.shape[0], device=mask.device)[:, None].expand(
        mask.shape)[mask]
    cols = (torch.cumsum(mask, dim=-1) - 1)[mask]
    outs = []
    for s in streams:
        o = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
        v = s[mask]
        o[rows, cols] = to_i32(v) if s.dtype == torch.int64 else v
        outs.append(o)
    return outs
