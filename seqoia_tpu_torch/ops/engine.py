"""K2 place_emit and K6 place_fill: placement + forward fill of a compacted
monotone stream.

Port of ``seqoia_tpu/ops/pallas_engine.py:place_emit`` and ``place_fill``.
Output slot t of row b takes the payloads of the last entry i < totals[b]
with keys[i] <= t, or ``inits`` before the first entry. ``place_fill``
returns the filled int32 streams; ``place_emit`` runs an ``Epilogue`` on
them instead (the codec modules define theirs). Both are one kernel,
``csrc/engine.cu``, with an epilogue selector: one block fills one tile of
4096 slots from the entries a warp's search finds for it, and stores it as
16-byte vectors. The plain versions below find each slot's entry with
``torch.searchsorted``.

Four epilogues convert channels on the way out (``CONVERSIONS``): a gray
source to RGB or RGBA words (R = G = B = the gray, the alpha kept) and a
colour source to gray or gray | alpha bytes (its green), each an existing
decode epilogue's store over the transformed word; ``place_emit`` counts
their launches under ``kernels.launches.K2.conv`` as well as under
``kernels.launches.K2``.

The TPU kernels bound their fill to ``max_gap`` slots past an entry (the
codec's gaps are bounded wherever the output is live); the port fills
without a bound, which is the same output wherever that holds, so it has
no ``max_gap`` argument and no window or ``entry_limit`` padding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils import trace
from . import _build
from ._plain import to_i32

# epilogue selectors of csrc/engine.cu
(EPI_FILL, EPI_DEC4, EPI_DEC3, EPI_MONO1, EPI_MONO2, EPI_ENC3, EPI_ENC1,
 EPI_ENCQ, EPI_GRAY4, EPI_GRAY3, EPI_GREEN1, EPI_GREEN2) = range(12)
# the decode epilogues that convert channels: a gray source to 4 or 3
# channels, a colour source to 1 or 2
CONVERSIONS = (EPI_GRAY4, EPI_GRAY3, EPI_GREEN1, EPI_GREEN2)
# the encode epilogues read the filled keys (each entry's byte offset)
_KEYED = (EPI_ENC3, EPI_ENC1, EPI_ENCQ)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """An output stage of place_emit.

    kind: the kernel's EPI_* selector; dtype: the output dtype; units:
    output elements per row as (num, den) of n_out; plain(filled, t, scal)
    the same stage in PyTorch, from the filled int64 streams (B, n_out),
    the slot positions (1, n_out) and the per-row scalars (B, S) int64."""

    kind: int
    dtype: torch.dtype
    plain: Callable
    units: tuple = (1, 1)


def _check(keys, payloads, totals, n_out):
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError("keys must be a (B, Mc) int32 tensor")
    for p in payloads:
        if p.shape != keys.shape or p.dtype != torch.int32:
            raise ValueError("payloads must match keys: (B, Mc) int32")
    if totals.shape != (keys.shape[0],):
        raise ValueError("totals must be (B,)")
    if n_out <= 0 or n_out % 4:
        raise ValueError("n_out must be a positive multiple of 4")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")


def _fill_plain(keys, streams, totals, n_out, inits, start: int = 0):
    """Filled int64 streams (B, n_out): stream value of each slot's entry,
    for the slots start .. start + n_out - 1 (a slot depends on no other,
    so a long output can be made range by range)."""
    bsz, mc = keys.shape
    dev = keys.device
    idx = torch.arange(mc, device=dev)
    masked = torch.where(idx[None, :] < totals.long()[:, None], keys.long(),
                         2**62)
    t = torch.arange(start, start + n_out, device=dev).expand(
        bsz, n_out).contiguous()
    gi = torch.searchsorted(masked, t, right=True) - 1
    has = gi >= 0
    gic = gi.clamp(min=0)
    return [torch.where(has, torch.gather(s.long(), 1, gic), int(ini))
            for s, ini in zip(streams, inits)]


def _launch(epi, keys, payloads, totals, n_out, scalars, inits, fill_keys,
            out0, outs_extra=(None, None, None)):
    bsz, mc = keys.shape
    keys = keys.contiguous()
    pays = [p.contiguous() for p in payloads] + [None] * (3 - len(payloads))
    ini = list(inits[: len(payloads)]) + [0] * (3 - len(payloads))
    ini_key = int(inits[len(payloads)]) if fill_keys else 0
    n_scal = 0 if scalars is None else scalars.shape[1]
    P = _build.ptr
    _build.launch(
        "engine", "k2_place", keys.device,
        epi, P(keys), P(pays[0]), P(pays[1]), P(pays[2]),
        P(totals), mc, bsz, int(n_out), P(scalars), n_scal,
        int(ini[0]), int(ini[1]), int(ini[2]), ini_key,
        P(out0), P(outs_extra[0]), P(outs_extra[1]), P(outs_extra[2]))


def place_fill(keys, payloads, totals, n_out: int, inits, fill_keys=False):
    """K6. keys (B, Mc) int32 strictly increasing below totals; payloads:
    1-3 (B, Mc) int32 streams; inits: one fill value per stream, plus one
    for the keys when ``fill_keys``. Returns [(B, n_out) int32] per
    payload, then the filled keys when ``fill_keys``."""
    payloads = list(payloads)
    _check(keys, payloads, totals, n_out)
    if not 1 <= len(payloads) <= 3:
        raise ValueError("place_fill takes 1 to 3 payload streams")
    streams = payloads + ([keys] if fill_keys else [])
    if len(inits) != len(streams):
        raise ValueError("one init per filled stream")
    if not keys.is_cuda:
        return [to_i32(f) for f in
                _fill_plain(keys, streams, totals, n_out, inits)]
    bsz = keys.shape[0]
    outs = [torch.empty((bsz, n_out), dtype=torch.int32, device=keys.device)
            for _ in streams]
    n_pay = len(payloads)
    extra = (outs[1] if n_pay >= 2 else None, outs[2] if n_pay == 3 else None,
             outs[-1] if fill_keys else None)
    trace.count("kernels.launches.K6")
    _launch(EPI_FILL, keys, payloads, totals.to(torch.int32).contiguous(),
            n_out, None, inits, fill_keys, outs[0], extra)
    return outs


def place_emit(keys, payloads, totals, scalars, n_out: int, inits,
               epilogue: Epilogue):
    """K2. As place_fill, then ``epilogue`` turns the filled streams into
    one (B, n_out * num // den) output of ``epilogue.dtype``. scalars: (B,
    S) int32 per-row values the epilogue reads. The encode epilogues read
    the filled keys too (their last init is the keys')."""
    payloads = list(payloads)
    _check(keys, payloads, totals, n_out)
    fill_keys = epilogue.kind in _KEYED
    streams = payloads + ([keys] if fill_keys else [])
    if len(inits) != len(streams) or len(payloads) > 3:
        raise ValueError("one init per filled stream, at most 3 payloads")
    if scalars.dim() != 2 or scalars.shape[0] != keys.shape[0]:
        raise ValueError("scalars must be (B, S)")
    if not keys.is_cuda:
        filled = _fill_plain(keys, streams, totals, n_out, inits)
        t = torch.arange(n_out, device=keys.device)[None, :]
        return epilogue.plain(filled, t, scalars.long())
    num, den = epilogue.units
    out = torch.empty((keys.shape[0], n_out * num // den),
                      dtype=epilogue.dtype, device=keys.device)
    trace.count("kernels.launches.K2")
    if epilogue.kind in CONVERSIONS:
        trace.count("kernels.launches.K2.conv")
    _launch(epilogue.kind, keys, payloads,
            totals.to(torch.int32).contiguous(), n_out,
            scalars.to(torch.int32).contiguous(), inits, fill_keys, out)
    return out
