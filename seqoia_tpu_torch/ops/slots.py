"""K7: per-slot last writer, the QOI-compat color index table.

Port of ``seqoia_tpu/ops/pallas_slots.py:slot_last_writer``. Every position
writes its value into slot ``hashes[i]``; a query reads slot ``qslots[i]``
as it stood before position i (reference: seqoia.h:563-582 in the encoder,
seqoia.h:753-755,785-787 in the decoder). The kernel is ``csrc/slots.cu``
(a per-slot running max of writer indices in one launch: 4096-entry tiles
chained by a decoupled look-back over one status word per tile and slot,
each warp resolving its groups of 32 entries by class masks, then one
gather; see its header for what bounds it on the H100);
``slot_last_writer_plain`` is the same function in plain PyTorch, one
running max per slot.

The Pallas kernel skips only whole 32768-entry tiles past ``n_live``; the
port returns ``init`` at every position at or past ``n_live``. Below
``n_live`` the two agree.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from ._plain import to_i32
from .scan import n_tiles

MAX_SLOTS = 128


def scratch_words(bsz: int, m: int, n_slots: int) -> int:
    """int32 words of a K7 launch's scratch over (bsz, m): a 64-bit tile
    counter and one 64-bit status word per tile and slot."""
    return 2 * (bsz * n_tiles(m) * n_slots + 1)


def slot_last_writer_plain(hashes, values, qslots, n_slots: int, init: int,
                           n_live):
    """Plain PyTorch K7 (see ``slot_last_writer``)."""
    h, q = hashes.long(), qslots.long()
    bsz, m = h.shape
    idx = torch.arange(m, device=h.device).expand(bsz, m)
    last = torch.full((bsz, m), -1, dtype=torch.long, device=h.device)
    for k in range(n_slots):
        w = torch.cummax(torch.where(h == k, idx, -1), dim=-1).values
        before = torch.cat([torch.full_like(w[:, :1], -1), w[:, :-1]], dim=-1)
        last = torch.where(q == k, before, last)
    found = (last >= 0) & (idx < n_live.long()[:, None])
    got = torch.gather(values.long(), 1, last.clamp(min=0))
    return to_i32(torch.where(found, got, init))


def slot_last_writer(hashes, values, qslots, n_slots: int = 64, init: int = 0,
                     n_live=None):
    """K7. For each position i < n_live[b] with qslots[i] = k in [0,
    n_slots): values[j] of the largest j < i with hashes[j] == k, else
    ``init``; ``init`` everywhere else. hashes outside [0, n_slots) never
    write (-1 marks a non-writer). hashes, values, qslots: (B, M) int32;
    n_live: (B,) (default M); n_slots <= 128. Returns (B, M) int32.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    if hashes.dim() != 2 or hashes.dtype != torch.int32:
        raise ValueError("hashes must be a (B, M) int32 tensor")
    for t in (values, qslots):
        if t.shape != hashes.shape or t.dtype != torch.int32:
            raise ValueError("values and qslots must match hashes: (B, M) "
                             "int32")
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"n_slots must be in [1, {MAX_SLOTS}]")
    bsz, m = hashes.shape
    dev = hashes.device
    if n_live is None:
        n_live = torch.full((bsz,), m, dtype=torch.int32, device=dev)
    if n_live.shape != (bsz,):
        raise ValueError("n_live must be (B,)")
    if not hashes.is_cuda:
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        return slot_last_writer_plain(hashes, values, qslots, n_slots, init,
                                      n_live)
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((bsz, m), **i32)
    scratch = torch.empty(scratch_words(bsz, m, n_slots), **i32)
    P = _build.ptr
    trace.count("kernels.launches.K7")
    _build.launch(
        "slots", "k7_slots", dev,
        P(hashes.contiguous()), P(values.contiguous()),
        P(qslots.contiguous()), P(n_live.to(**i32).contiguous()), bsz, m,
        n_slots, int(init), P(scratch), P(out))
    return out
