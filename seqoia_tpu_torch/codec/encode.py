"""Full-file encode through the port (``seqoia_tpu/codec/encode_jax.py``).

Pixel normalization to the encoder's initial-state conventions, a
power-of-two pixel bucket, and one encode: the front (K3, or the ``.qoi``
front) computes the exact stream total before K2 runs, and K2's output is
sized from it, so a call runs one front and one K2 and never retries.
SQOA and QOI-compat (``.qoi``) streams alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from .._device import resolve
from ..utils import trace
from .encode_v2 import encode_stream


def normalize_pixels_packed(pixels, desc: spec.SqoaDesc) -> np.ndarray:
    """Flat interleaved input -> (N,) int32 packed r|g<<8|b<<16|a<<24 (mono:
    gray in g, r = b = 0; no alpha: a = 255)."""
    n = desc.n_pixels
    stride = desc.norm_channels
    arr = np.asarray(pixels, dtype=np.uint8).reshape(n, stride)
    out = np.empty((n, 4), dtype=np.uint8)
    if desc.col_channels == 3:
        out[:, :3] = arr[:, :3]
    else:
        out[:, 0] = 0
        out[:, 1] = arr[:, 0]
        out[:, 2] = 0
    out[:, 3] = arr[:, desc.col_channels] if desc.has_alpha else 255
    return out.reshape(-1).view("<u4").view(np.int32)


def pixel_bucket(n: int) -> int:
    """Power-of-two pixel bucket the encode runs at."""
    return 1 << max(n - 1, 1).bit_length()


@trace.entry_point("api.encode")
def encode(pixels, desc: spec.SqoaDesc, device="cuda") -> bytes | None:
    """Encode to SQOA (or, with ``desc.qoi_compat``, QOI-compatible)
    bytes, or None on invalid arguments (mirrors sqoa_encode's contract,
    seqoia.h:465-480)."""
    dev = resolve(device)
    if pixels is None or not spec.validate_encode_desc(desc):
        return None
    rgba_np = normalize_pixels_packed(pixels, desc)
    n = desc.n_pixels
    n_pad = pixel_bucket(n)
    if n_pad > n:
        rgba_np = np.concatenate([rgba_np, np.zeros(n_pad - n, np.int32)])
    rgba = torch.from_numpy(rgba_np).to(dev)
    out, total = encode_stream(rgba, n, colch=desc.col_channels,
                               compat=bool(desc.qoi_compat))
    trace.host_sync("total")
    return (spec.pack_header(desc)
            + out[: int(total)].cpu().numpy().tobytes())
