"""Batched and large-image codec pipelines on a card or a mesh of devices."""

from .batch import (BatchDecoder, BatchEncoder, DecodeResult, corpus_decode,
                    corpus_encode)
from .mesh import batch_sharding, default_mesh
from .tiled import (decode_large, decode_large_shardmap, encode_large,
                    encode_large_shardmap)

__all__ = [
    "BatchDecoder",
    "BatchEncoder",
    "DecodeResult",
    "corpus_decode",
    "corpus_encode",
    "default_mesh",
    "batch_sharding",
    "encode_large",
    "encode_large_shardmap",
    "decode_large",
    "decode_large_shardmap",
]
