"""K8: inclusive associative scan along the last axis of (B, M) int32 arrays.

Port of ``seqoia_tpu/ops/pallas_scan.py:tile_scan`` and its wrappers
(``cummax``, ``cumsum``, ``fill_forward``, ``segmented_modsum``,
``compose_state_maps``). The kernel is ``csrc/scan.cu`` (one launch, tiles
chained by a decoupled look-back, ``csrc/lookback.cuh``; see its header for
the design and what bounds it on the H100), one kernel with a combine
selector. The plain versions run
``_plain.hillis_steele`` with the same combine, in int64, and wrap once to
the int32 patterns the kernel produces. None of the combines commute:
each is applied as combine(left, right).
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from ._plain import hillis_steele, to_i32

INT_MIN = -(2**31)
TILE = 4096  # entries per tile of the look-back kernels (K5, K8)
IDENTITY_MAP = 0 | (1 << 3) | (2 << 6) | (3 << 9) | (4 << 12)
_M2, _F2 = 0x00FF00FF, 0x01000100


def _comb_max(left, right):
    return (torch.maximum(left[0], right[0]),)


def _comb_sum(left, right):
    return (left[0] + right[0],)


def _comb_fill(left, right):
    (lv, lf), (rv, rf) = left, right
    return torch.where(rf != 0, rv, lv), lf | rf


def _comb_segmod(left, right):
    (l,), (r,) = left, right
    s = ((l & _M2) + (r & _M2)) & _M2
    ch0 = torch.where((r >> 8) & 1 != 0, r & 0xFF, s & 0xFF)
    ch1 = torch.where((r >> 24) & 1 != 0, r & 0xFF0000, s & 0xFF0000)
    return (ch0 | ch1 | (l & _F2) | (r & _F2),)


def _comb_maps(left, right):
    (l,), (r,) = left, right
    out = torch.zeros_like(l)
    for e in range(5):
        fe = (l >> (3 * e)) & 7
        out = out | (((r >> (3 * fe)) & 7) << (3 * e))
    return (out,)


# combine name -> (csrc/scan.cu selector, arrays scanned jointly, plain combine)
COMBINES = {
    "max": (0, 1, _comb_max),
    "sum": (1, 1, _comb_sum),
    "fill": (2, 2, _comb_fill),
    "segmod": (3, 1, _comb_segmod),
    "maps": (4, 1, _comb_maps),
}


def n_tiles(m: int) -> int:
    """Tiles of one row of m entries in the look-back kernels (at least
    one, so an empty row still has a tile that writes its total)."""
    return max(1, -(-m // TILE))


def scratch_words(bsz: int, m: int) -> int:
    """int32 words of a look-back launch's scratch over (bsz, m): a 64-bit
    tile counter and one 64-bit status word per tile (csrc/lookback.cuh)."""
    return 2 * (bsz * n_tiles(m) + 1)


def tile_scan_plain(arrays, combine: str):
    """Plain PyTorch K8: the same inclusive scan by log-step doubling."""
    _, _, comb = COMBINES[combine]
    if combine == "fill":
        # the kernels start each row's carry at the identity (0, 0), which
        # the fill combine does not keep on its left: the value is 0 before
        # the first flag, not the row's first value
        arrays = (torch.where(arrays[1] != 0, arrays[0], 0), arrays[1])
    outs = hillis_steele(tuple(a.long() for a in arrays), comb)
    return tuple(to_i32(o) for o in outs)


def tile_scan(arrays, combine: str):
    """K8. arrays: the (B, M) int32 tensors scanned jointly (two for
    "fill": values and flags, the flags 0 or 1, one otherwise); combine: a
    key of COMBINES.
    Returns the inclusive scans, one (B, M) int32 tensor per array.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    arrays = tuple(arrays)
    sel, n_arr, _ = COMBINES[combine]
    if len(arrays) != n_arr:
        raise ValueError(f"combine {combine!r} scans {n_arr} array(s)")
    x0 = arrays[0]
    for a in arrays:
        if a.dim() != 2 or a.dtype != torch.int32 or a.shape != x0.shape:
            raise ValueError("arrays must be (B, M) int32 tensors of one shape")
    if not x0.is_cuda:
        if x0.device.type != "cpu":
            raise ValueError(f"unsupported device {x0.device}")
        return tile_scan_plain(arrays, combine)
    bsz, m = x0.shape
    dev = x0.device
    xs = [a.contiguous() for a in arrays] + [None] * (2 - n_arr)
    ys = [torch.empty((bsz, m), dtype=torch.int32, device=dev)
          for _ in range(n_arr)] + [None] * (2 - n_arr)
    scratch = torch.empty(scratch_words(bsz, m), dtype=torch.int32,
                          device=dev)
    P = _build.ptr
    trace.count("kernels.launches.K8")
    _build.launch("scan", "k8_scan", dev, sel, P(xs[0]), P(xs[1]), bsz, m,
                  P(scratch), P(ys[0]), P(ys[1]))
    return tuple(ys[:n_arr])


def cummax(x):
    """Inclusive running maximum."""
    return tile_scan((x,), "max")[0]


def cumsum(x):
    """Inclusive sum, wrapping like int32."""
    return tile_scan((x,), "sum")[0]


def fill_forward(values, valid, init: int):
    """The value at the most recent position where ``valid`` holds, or
    ``init`` before any."""
    v, f = tile_scan((values, valid.to(torch.int32)), "fill")
    return torch.where(f != 0, v, init)


def segmented_modsum(packed):
    """Inclusive segmented sum mod 256 over ``scan_ops.pack_pair`` words: a
    set flag restarts its channel at its value."""
    return tile_scan((packed,), "segmod")[0]


def compose_state_maps(maps):
    """Inclusive composition scan of 5-state maps: out[i] = m_i o ... o
    m_0."""
    return tile_scan((maps,), "maps")[0]
