"""Device -> host transfer of large codec outputs.

Port of ``seqoia_tpu/utils/transfer.py`` (``fetch_flat``): the decoded
pixels and encoded streams of the large-image path come back through here,
as one copy into pinned host memory. The JAX version cuts the array into
slices and fans them out over host threads to get around a slow
device-to-host link; a card's copy engine runs one copy at the link's rate,
so there is nothing to cut.
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace


def fetch_flat(x, n_elems: int | None = None) -> np.ndarray:
    """The first ``n_elems`` (default: all) of a rank-1 tensor as a numpy
    array. For a CUDA tensor the array is a view of a pinned buffer, filled
    by one copy and one synchronize; it stays page-locked while the array
    lives, which a caller that hands it on says in its own contract. Opens
    the span ``parallel.fetch``, and in it ``parallel.wait`` (``fetch``)
    around the synchronize."""
    if x.dim() != 1:
        raise ValueError("fetch_flat takes a rank-1 tensor")
    n = x.shape[0] if n_elems is None else min(int(n_elems), x.shape[0])
    with trace.span("parallel.fetch", bytes=n * x.element_size()):
        if not x.is_cuda:
            return x[:n].numpy()
        out = torch.empty(n, dtype=x.dtype, pin_memory=True)
        out.copy_(x[:n], non_blocking=True)
        with trace.span("parallel.wait", why="fetch"):
            torch.cuda.current_stream(x.device).synchronize()
        return out.numpy()
