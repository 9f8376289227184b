"""Native (C) host codec for the port.

The port's own copy of the clean-room C runtime (``sqoa_native.c``). The
port needs it for the OP_REF fallback (REF streams teleport the decoder's
cursor, which the parallel front-end cannot follow), as the parity oracle
of ``chip_smoke.py``, and for ``compat_probe``, which measures how deep a
``.qoi`` stream's INDEX reads chain. The library is built with ``cc`` on first use
into the git-ignored ``seqoia_tpu_torch/_build/`` directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading

import numpy as np

from ..ops._build import BUILD_DIR, compile_shared, finish_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sqoa_native.c")

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libsqoa_native-{tag}.so")
        if not os.path.exists(path):
            cc = os.environ.get("CC", "cc")
            finish_shared(compile_shared(
                [cc, "-O3", "-std=c11", "-shared", "-fPIC", _SRC], path))
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.sqn_encode.restype = ctypes.c_int64
        lib.sqn_encode.argtypes = [
            u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, u8p,
        ]
        lib.sqn_decode.restype = ctypes.c_int64
        lib.sqn_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p, u32p]
        lib.sqn_peek_header.restype = ctypes.c_int
        lib.sqn_peek_header.argtypes = [u8p, ctypes.c_int64, u32p]
        lib.sqn_compat_probe.restype = ctypes.c_int64
        lib.sqn_compat_probe.argtypes = [
            u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.sqn_scan_chunks.restype = ctypes.c_int64
        lib.sqn_scan_chunks.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode(pixels, width: int, height: int, channels: int,
           colorspace: int = 0, qoi_compat: int = 0) -> bytes | None:
    """Encode a flat uint8 pixel buffer; returns the stream or None."""
    lib = _load()
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
    has_alpha = (channels & 1) == 0
    colch = 1 if channels < 3 else 3
    # one byte over the reference's worst case, which omits the start byte
    out = np.empty(width * height * (colch + has_alpha + 1) + 23, np.uint8)
    n = lib.sqn_encode(_u8ptr(pixels), width, height, channels, colorspace,
                       qoi_compat, _u8ptr(out))
    if n < 0:
        return None
    return out[:n].tobytes()


def peek_header(data: bytes):
    """Return (width, height, channels, colorspace, qoi_compat) or None."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    desc = np.zeros(5, dtype=np.uint32)
    rc = lib.sqn_peek_header(
        _u8ptr(buf), len(data),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        return None
    return tuple(int(x) for x in desc)


def decode(data: bytes, channels: int = 0):
    """Decode a stream. Returns (flat uint8 pixels, (width, height,
    channels, colorspace, qoi_compat)) or (None, None)."""
    lib = _load()
    hdr = peek_header(data)
    if hdr is None or channels > 4 or channels < 0:
        return None, None
    width, height, hdr_channels = hdr[:3]
    colch = 1 if hdr_channels < 3 else 3
    out_ch = channels if channels else colch + (1 - (hdr_channels & 1))
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(width * height * out_ch, dtype=np.uint8)
    desc = np.zeros(5, dtype=np.uint32)
    n = lib.sqn_decode(
        _u8ptr(buf), len(data), channels, _u8ptr(out),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if n < 0:
        return None, None
    return out, tuple(int(x) for x in desc)


def compat_probe(data: bytes):
    """INDEX-chain depth of a color ``.qoi`` stream, in one sequential pass
    (``sqn_compat_probe``). Returns (max_depth, n_ops, n_index, n_px,
    strict_max_depth), or None for a SQOA, mono or malformed stream.

    strict_max_depth is the longest chain of INDEX reads, each of a value
    that depends on the one before: about the passes the index fixpoint
    (``codec/decode_compat.py``) needs from its zeroed guesses. max_depth
    is a predictor that lets a read of a value already stored by a
    shallower op count at that op's depth (reads of slot 0 stay strict)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    stats = np.zeros(4, dtype=np.int64)
    d = lib.sqn_compat_probe(
        _u8ptr(buf), len(data),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if d < 0:
        return None
    return (int(d),) + tuple(int(x) for x in stats)


def scan_chunks(data: bytes, n_chunks: int):
    """Op-aligned shard boundaries of a SQOA (non-compat) stream, from one
    token hop without value decoding (``sqn_scan_chunks``). Returns an
    (n_chunks, 4) int64 array of {byte position, first pixel, first color
    anchor pixel (absolute, -1 if none), first alpha anchor pixel (absolute,
    -1 if none)} per chunk, or None for a stream the hop rejects (compat,
    REF ops, malformed)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros((n_chunks, 4), dtype=np.int64)
    rc = lib.sqn_scan_chunks(
        _u8ptr(buf), len(data), n_chunks,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        return None
    return out
