"""K4: raw interleaved pixel bytes -> packed int32 pixels, on the card.

Port of ``seqoia_tpu/ops/pallas_pack.py`` (``pack_words``,
``normalize_pixels_device``). The encoder consumes ``r | g<<8 | b<<16 |
a<<24`` pixels (the normalized form of seqoia.h:475-486,520-525); the host
only pads and views the raw bytes as int32 words, and the kernel
(``csrc/pack.cu``, one coalesced pass; see its header) expands them:

* stride 3 (RGB/BGR):     ``r | g<<8 | b<<16 | 0xFF000000``
* stride 2 (gray, alpha): ``g<<8 | a<<24``
* stride 1 (gray):        ``g<<8 | 0xFF000000``

Stride 4 needs no kernel: the words are the pixels (BGR(A) encodes like
RGB(A), seqoia.h:482). ``pack_words_plain`` is the same function in plain
PyTorch (a byte view, an index and a byte store).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..utils import trace
from . import _build

TILE = 32768  # pixels a large image is padded to


def _check(words, stride):
    if stride not in (1, 2, 3):
        raise ValueError("stride must be 1, 2 or 3")
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a (B, N * stride // 4) int32 tensor")
    if words.shape[1] % stride:
        raise ValueError("a row must hold whole groups of 4 pixels")


def pack_words_plain(words, stride: int):
    """Plain PyTorch K4 (see module docstring)."""
    _check(words, stride)
    bsz, wlen = words.shape
    n = wlen * 4 // stride
    raw = words.contiguous().view(torch.uint8).reshape(bsz, n, stride)
    out = torch.zeros((bsz, n, 4), dtype=torch.uint8, device=words.device)
    if stride == 3:
        out[:, :, :3] = raw
    else:
        out[:, :, 1] = raw[:, :, 0]
    out[:, :, 3] = raw[:, :, 1] if stride == 2 else 255
    return out.view(torch.int32).reshape(bsz, n)


def pack_words(words, stride: int):
    """K4. words: (B, N * stride // 4) int32, the little-endian view of the
    raw interleaved bytes, N a multiple of 4; stride = the image's
    norm_channels (1, 2 or 3). Returns (B, N) int32 packed pixels.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    _check(words, stride)
    if not words.is_cuda:
        if words.device.type != "cpu":
            raise ValueError(f"unsupported device {words.device}")
        return pack_words_plain(words, stride)
    bsz, wlen = words.shape
    n = wlen * 4 // stride
    words = words.contiguous()
    out = torch.empty((bsz, n), dtype=torch.int32, device=words.device)
    trace.count("kernels.launches.K4")
    _build.launch("pack", "k4_pack_words", words.device, _build.ptr(words),
                  _build.ptr(out), bsz * n, stride)
    return out


def normalize_pixels_device(pixels_u8, desc, device="cuda"):
    """Flat raw uint8 pixels (host) -> (n_pad,) packed int32 pixels on
    ``device``, n_pad = desc.n_pixels rounded up to a multiple of 32768.

    The host pads the bytes with zeros into one buffer (pinned when the
    target is a card) and views them as int32; one copy moves the raw bytes
    (stride per pixel, not 4) and K4 expands them there. The padding pixels
    come out as 0xFF000000 at stride 3, 0 at stride 2, 0xFF000000 at stride
    1 and 0 at stride 4 (no kernel); the encoder reads none of them. Opens
    the spans ``parallel.stage.fill`` (the host buffer) and
    ``parallel.stage.dispatch`` (the copy up and K4)."""
    dev = resolve(device)
    stride = desc.norm_channels
    n = desc.n_pixels
    n_pad = -(-n // TILE) * TILE
    with trace.span("parallel.stage.fill", bytes=n_pad * stride):
        raw = np.asarray(pixels_u8, np.uint8).reshape(-1)[: n * stride]
        host = torch.empty(n_pad * stride, dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        host_np = host.numpy()
        host_np[: raw.size] = raw
        host_np[raw.size:] = 0
    with trace.span("parallel.stage.dispatch", device=str(dev)):
        words = host.to(dev, non_blocking=True).view(torch.int32)
        if stride == 4:
            return words
        return pack_words(words[None], stride)[0]
