"""seqoia_tpu_torch — the SQOA lossless image codec on an NVIDIA H100.

The PyTorch/CUDA port of ``seqoia_tpu``: the same public surface
(``encode`` / ``decode`` / ``read`` / ``write``, parity surface for the
reference's sqoa_encode / sqoa_decode / sqoa_read / sqoa_write,
seqoia.h:336-374) and byte-exact streams. Two backends:

* ``backend="cuda"`` (default) — the card path: hand-written CUDA kernels
  (``csrc/``) under PyTorch. ``device="cpu"`` runs the same pipeline
  through the kernels' plain PyTorch versions instead.
* ``backend="native"`` — the C host codec.

QOI-compatible (``.qoi``) streams encode and decode on the card too, in
color and, for the decode, mono (a decoder-only quirk: a header with 1 or 2
channels and a 128-slot index).

``encode_large`` / ``decode_large`` (one 100-400 Mpx image, with shard
forms), ``BatchDecoder`` / ``corpus_decode`` (many streams, icons packed
many to a row) and ``BatchEncoder`` / ``corpus_encode`` (many images, one
encode a class) come from ``seqoia_tpu_torch.parallel`` and load on first
use.

Tracing (``seqoia_tpu_torch.utils.trace``): each public call of the card
path opens a root span (``api.decode``, ``api.encode``,
``api.batch_decode``, ``api.batch_encode``, ``api.encode_large``,
``api.decode_large`` and the shard forms), and its steps open spans under
it (``parallel.*``: staging, dispatch, waits on the card, the copies down;
``codec.*``: the ``.qoi`` fixpoint's passes, K9's rows). Spans are off
until ``trace.enable()`` is called or a ``torch.profiler`` session records;
off, a span is one check. Under a profiler every span is also a
``seqoia/<name>`` range on the profiler's clock, beside the card's kernels
and copies: the timeline. ``trace.calls()`` gives the recorded calls with
their spans' self times and counter deltas: the numbers. The counters
(``trace.counters()``: kernel launches, the codec's host reads of device
values) count always.
"""

from __future__ import annotations

import numpy as np

from . import native, spec
from .spec import (
    CHAN_BGR,
    CHAN_BGRA,
    CHAN_MONO,
    CHAN_MONOA,
    CHAN_RGB,
    CHAN_RGBA,
    LINEAR,
    SRGB,
    SqoaDesc,
)

__all__ = [
    "SqoaDesc",
    "encode",
    "decode",
    "read",
    "write",
    "spec",
    "native",
    "CHAN_MONO", "CHAN_MONOA", "CHAN_RGB", "CHAN_RGBA", "CHAN_BGR",
    "CHAN_BGRA", "SRGB", "LINEAR",
]

_PARALLEL = (
    "BatchDecoder", "BatchEncoder", "DecodeResult", "corpus_decode",
    "corpus_encode", "encode_large", "encode_large_shardmap", "decode_large",
    "decode_large_shardmap",
)
__all__ += list(_PARALLEL)


def __getattr__(name: str):
    if name in _PARALLEL:
        from . import parallel

        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _check_backend(backend: str) -> None:
    if backend not in ("cuda", "native"):
        raise ValueError(f"backend must be 'cuda' or 'native', not {backend!r}")


def encode(pixels, desc: SqoaDesc, backend: str = "cuda",
           device="cuda") -> bytes | None:
    """Encode raw pixels into a SQOA image in memory. Returns the encoded
    bytes, or None on invalid parameters."""
    _check_backend(backend)
    if backend == "native":
        if desc is None or pixels is None or not spec.validate_encode_desc(desc):
            return None
        return native.encode(
            np.asarray(pixels, dtype=np.uint8).ravel(), desc.width,
            desc.height, desc.channels, desc.colorspace, desc.qoi_compat,
        )
    from . import codec

    return codec.encode(pixels, desc, device=device)


def decode(data: bytes, channels: int = 0, backend: str = "cuda",
           device="cuda"):
    """Decode a SQOA image from memory. Returns (pixels, desc) where pixels
    is a flat uint8 numpy array, or (None, None) on malformed input."""
    _check_backend(backend)
    if backend == "native":
        pixels, d = native.decode(bytes(data), channels)
        if pixels is None:
            return None, None
        return pixels, SqoaDesc(*d)
    from . import codec

    return codec.decode(data, channels, device=device)


def write(filename: str, pixels, desc: SqoaDesc, backend: str = "cuda",
          device="cuda") -> int:
    """Encode and write to the file system; returns bytes written or 0."""
    data = encode(pixels, desc, backend=backend, device=device)
    if data is None:
        return 0
    try:
        with open(filename, "wb") as f:
            f.write(data)
    except OSError:
        return 0
    return len(data)


def read(filename: str, channels: int = 0, backend: str = "cuda",
         strict: bool = False, device="cuda"):
    """Read and decode a SQOA file; returns (pixels, desc) or (None, None).

    With ``strict=True`` I/O failures raise ``OSError`` and files that
    read but do not decode raise ``ValueError``."""
    try:
        with open(filename, "rb") as f:
            data = f.read()
    except OSError:
        if strict:
            raise
        return None, None
    pixels, desc = (decode(data, channels, backend=backend, device=device)
                    if data else (None, None))
    if pixels is None and strict:
        raise ValueError(f"undecodable SQOA data in {filename!r}")
    return pixels, desc
