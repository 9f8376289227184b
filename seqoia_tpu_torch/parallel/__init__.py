"""Batched and large-image codec pipelines on one card."""

from .batch import BatchDecoder, DecodeResult, corpus_decode
from .tiled import (decode_large, decode_large_shardmap, encode_large,
                    encode_large_shardmap)

__all__ = [
    "BatchDecoder",
    "DecodeResult",
    "corpus_decode",
    "encode_large",
    "encode_large_shardmap",
    "decode_large",
    "decode_large_shardmap",
]
