"""Batched and large-image codec pipelines on one card."""

from .batch import (BatchDecoder, BatchEncoder, DecodeResult, corpus_decode,
                    corpus_encode)
from .tiled import (decode_large, decode_large_shardmap, encode_large,
                    encode_large_shardmap)

__all__ = [
    "BatchDecoder",
    "BatchEncoder",
    "DecodeResult",
    "corpus_decode",
    "corpus_encode",
    "encode_large",
    "encode_large_shardmap",
    "decode_large",
    "decode_large_shardmap",
]
