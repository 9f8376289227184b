"""Full-file decode through the port (``seqoia_tpu/codec/decode_jax.py:309``).

Header parsing, power-of-two buckets for the byte buffer and the pixel
slots, the card decode, and the host decoder for streams that hold OP_REF
(their cursor teleports, which the parallel front-end cannot follow; the
reference encoder never emits REF).
"""

from __future__ import annotations

import torch

from .. import native, spec
from .._device import resolve
from .decode_v2 import decode_stream


def _next_pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def decode(data: bytes, channels: int = 0, device="cuda"):
    """Decode a SQOA image. Returns (flat uint8 pixels, SqoaDesc) or
    (None, None) on malformed input, mirroring sqoa_decode's contract
    (seqoia.h:652-713). QOI-compatible streams are not ported yet."""
    dev = resolve(device)
    if channels < 0 or channels > 4:
        return None, None
    desc = spec.unpack_header(bytes(data[: spec.HEADER_SIZE + 1]) + b"\0" * 8
                              if len(data) >= spec.HEADER_SIZE + 1 else b"")
    if desc is None or len(data) < spec.HEADER_SIZE + spec.PADDING_SIZE:
        return None, None
    if desc.qoi_compat:
        raise NotImplementedError(
            "QOI-compat decode is not ported yet (ROADMAP.md Queue 1 item 8)")
    colch = desc.col_channels
    out_ch = channels if channels else colch + (1 if desc.has_alpha else 0)
    n_pix = desc.n_pixels
    buf = torch.zeros(_next_pow2(len(data)), dtype=torch.uint8)
    buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out, has_ref = decode_stream(
        buf.to(dev), len(data) - spec.PADDING_SIZE, n_pix, colch=colch,
        out_ch=out_ch, n_max=_next_pow2(max(n_pix, 4)),
        src_alpha=desc.has_alpha,
    )
    if bool(has_ref):
        pixels, d = native.decode(bytes(data), channels)
        if pixels is None:
            return None, None
        return pixels, spec.SqoaDesc(*d)
    return out[: n_pix * out_ch].cpu().numpy(), desc
