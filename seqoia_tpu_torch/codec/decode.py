"""Full-file decode through the port (``seqoia_tpu/codec/decode_jax.py:309``).

Header parsing, power-of-two buckets for the byte buffer and the pixel
slots, and the card decode. SQOA streams that hold OP_REF (their cursor
teleports, which the parallel front-end cannot follow; the reference
encoder never emits REF) go to K10, the sequential REF decoder on the same
device, when ``SEQOIA_REF_CUDA=1`` is set (the port's name for the JAX
package's ``SEQOIA_REF_TPU``), and to the host decoder otherwise, the JAX
package's default too. QOI-compat streams decode on the card, color ones
whether or not the index fixpoint settles them in its ``_MAX_ITERS`` passes
(``decode_compat``; the JAX package decodes those it does not settle on
the host), mono ones through K9's mono step.
"""

from __future__ import annotations

import os

import torch

from .. import native, spec
from .._device import resolve
from ..ops import ref
from ..utils import trace
from .decode_compat import decode_stream_compat_batched
from .decode_v2 import decode_stream


def _next_pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _host(data: bytes, channels: int):
    pixels, d = native.decode(bytes(data), channels)
    if pixels is None:
        return None, None
    return pixels, spec.SqoaDesc(*d)


@trace.entry_point("api.decode")
def decode(data: bytes, channels: int = 0, device="cuda"):
    """Decode a SQOA or QOI-compat image. Returns (flat uint8 pixels,
    SqoaDesc) or (None, None) on malformed input, mirroring sqoa_decode's
    contract (seqoia.h:652-713)."""
    dev = resolve(device)
    if channels < 0 or channels > 4:
        return None, None
    desc = spec.unpack_header(bytes(data[: spec.HEADER_SIZE + 1]) + b"\0" * 8
                              if len(data) >= spec.HEADER_SIZE + 1 else b"")
    if desc is None or len(data) < spec.HEADER_SIZE + spec.PADDING_SIZE:
        return None, None
    colch = desc.col_channels
    out_ch = channels if channels else colch + (1 if desc.has_alpha else 0)
    n_pix = desc.n_pixels
    n_max = _next_pow2(max(n_pix, 4))
    buf = torch.zeros(_next_pow2(len(data)), dtype=torch.uint8)
    buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    buf = buf.to(dev)
    clen = len(data) - spec.PADDING_SIZE
    if desc.qoi_compat:
        out, _ = decode_stream_compat_batched(
            buf[None], torch.tensor([clen]), torch.tensor([n_pix]),
            colch=colch, out_ch=out_ch, n_max=n_max)
        return out[0, : n_pix * out_ch].cpu().numpy(), desc
    out, has_ref = decode_stream(
        buf, clen, n_pix, colch=colch, out_ch=out_ch, n_max=n_max,
        src_alpha=desc.has_alpha,
    )
    trace.host_sync("has_ref")
    if bool(has_ref):
        if os.environ.get("SEQOIA_REF_CUDA", "") != "1":
            return _host(data, channels)
        out, err, _ = ref.ref_decode(buf, clen, n_pix, colch=colch,
                                  out_ch=out_ch, n_max=n_max)
        trace.host_sync("ref_error")
        if bool(err):
            return None, None
    return out[: n_pix * out_ch].cpu().numpy(), desc
