"""The port's codec: SQOA and QOI-compat encode/decode pipelines on the
card."""

from .decode import decode
from .decode_compat import decode_stream_compat_batched
from .decode_v2 import (decode_stream, decode_stream_batched,
                        decode_stream_packed)
from .encode import encode, normalize_pixels_packed
from .encode_v2 import (encode_stream, encode_stream_batched,
                        encode_stream_flat)

__all__ = [
    "decode",
    "decode_stream",
    "decode_stream_batched",
    "decode_stream_compat_batched",
    "decode_stream_packed",
    "encode",
    "encode_stream",
    "encode_stream_batched",
    "encode_stream_flat",
    "normalize_pixels_packed",
]
