"""What crosses from the JAX package to the port.

The codec has no learned weights: the state that crosses between the two
packages is intermediate data — packed int32 pixels, the compacted
(keys, payloads, totals) streams in the slack layout the Pallas fronts and
``pallas_engine.compact`` return (entries valid below totals; the slack
past them is never read), scans, resolved index reads and the per-row
scalars. These helpers turn the JAX side's numpy outputs
into the port's tensors, so a test can feed a Pallas stage's output into
the port's next stage.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor(x, device="cpu", dtype=torch.int32) -> torch.Tensor:
    """A numpy array (or anything np.asarray takes) as a contiguous tensor
    of ``dtype`` on ``device`` (a copy: the JAX side's buffers are
    read-only)."""
    arr = np.array(x, copy=True)
    return torch.from_numpy(arr).to(device=device, dtype=dtype).contiguous()


def compact(keys, payloads, totals, m: int, device="cpu"):
    """pallas_engine.compact's outputs -> the port's K5 outputs (keys,
    [payloads], totals). The Pallas streams are (B, M + slack) with garbage
    past totals; the port's are (B, M), and these are zero past totals.
    K7's and K8's outputs are plain (B, M) int32 arrays: ``tensor``."""
    totals = tensor(totals, device)
    live = torch.arange(m, device=device)[None, :] < totals[:, None]

    def trim(x):
        return torch.where(live, tensor(x, device)[:, :m], 0)

    return trim(keys), [trim(p) for p in payloads], totals


def decode_front(keys, payloads, totals, has_ref, device="cpu"):
    """pallas_frontend.decode_front_compact's outputs -> the port's K1
    outputs (keys, payload, totals, has_ref)."""
    (pays,) = payloads
    return (tensor(keys, device), tensor(pays, device),
            tensor(totals, device), tensor(has_ref, device))


def encode_front(keys, payloads, entry_totals, chunk_totals, last_change,
                 device="cpu"):
    """pallas_encode.encode_front_compact's outputs -> the port's K3
    outputs (keys, [cur, meta], entry_totals, chunk_totals, last_change)."""
    cur, meta = payloads
    return (tensor(keys, device), [tensor(cur, device), tensor(meta, device)],
            tensor(entry_totals, device), tensor(chunk_totals, device),
            tensor(last_change, device))
