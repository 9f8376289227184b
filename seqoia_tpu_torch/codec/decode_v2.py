"""SQOA (non-compat) stream decode on the card.

Port of the fused branch of ``seqoia_tpu/codec/decode_v2.py``
(``decode_stream_batched``, ``decode_stream``): K1 turns the bytes into the
compacted op stream, K2 places it and emits the pixels through the decode
epilogue of the source's and the output's channels (``_epilogue``). A color
source decoded to 1/2 channels or a mono source to 3/4 takes one of K2's
conversion epilogues, where the JAX package fills the pixels and emits them
in XLA (``_emit_pixels``; for mono sources at 3/4 channels after its
unfused front, whose compacted output K1 gives too).

The compat (``.qoi``) decode tokenizes with ``_tokenize`` below, the JAX
package's unfused tokenizer in its compat color and mono forms (K8
composes the countdown maps).
"""

from __future__ import annotations

import torch

from .. import spec
from ..ops import engine, frontend, scan_ops
from ..ops._plain import to_i32
from ..utils import trace

_INIT_PACKED = -16777216  # (0, 0, 0, 255): the decoder's initial pixel


def _token_lengths(b, colch: int = 3):
    """QOI-compat token length per byte position, assuming a token starts
    there. Color: INDEX, DIFF and RUN 1 byte, LUMA 2, RGB 4, RGBA 5. Mono
    (colch 1): RGB 2, RGBA 3, any other tag 1 (a tag below 128 is an INDEX
    of the 128-slot table)."""
    if colch == 1:
        lens = torch.where(b == spec.OP_RGB, 2, 1)
        return torch.where(b == spec.OP_RGBA, 3, lens)
    lens = 1 + ((b & spec.MASK_2) == spec.OP_LUMA).to(torch.int32)
    lens = torch.where(b == spec.OP_RGB, 4, lens)
    lens = torch.where(b == spec.OP_RGBA, 5, lens)
    return torch.where(b < spec.QOI_INDEX_SIZE, 1, lens)


def _tokenize(b, chunks_len, colch: int = 3):
    """Token-start mask of (B, M) int32 QOI-compat streams (tokens start
    after the header; chunks_len (B, 1) ends them)."""
    state = scan_ops.tokenizer_states(_token_lengths(b, colch),
                                      spec.HEADER_SIZE)
    idx = torch.arange(b.shape[-1], device=b.device)
    return (state == 0) & (idx >= spec.HEADER_SIZE) & (idx < chunks_len)


def _dec4(filled, t, scal):
    return to_i32(torch.where(t < scal[:, :1], filled[0], 0))


def _dec3(filled, t, scal):
    words = _dec4(filled, t, scal)
    bsz, n = words.shape
    rgb = words.view(torch.uint8).reshape(bsz, n, 4)[:, :, :3]
    return rgb.reshape(bsz, n * 3).view(torch.int32)


def _mono1(filled, t, scal):
    return torch.where(t < scal[:, :1], filled[0] & 255, 0).to(torch.uint8)


def _mono2(filled, t, scal):
    f = filled[0]
    v = (f & 255) | (((f >> 24) & 255) << 8)
    return torch.where(t < scal[:, :1], v, 0).to(torch.int32).to(torch.uint16)


def _gray_word(f):
    """A gray source's packed pixel (gray in byte 0, alpha in byte 3) as the
    RGBA word of its gray: R = G = B = the gray, the alpha kept."""
    f = f.long()
    return (f & 255) * 0x010101 | (f & 0xFF000000)


def _green_word(f):
    """A colour pixel as a gray source's word: its green in byte 0, its
    alpha kept."""
    f = f.long()
    return ((f >> 8) & 255) | (f & 0xFF000000)


def _converted(plain, word):
    """The plain form of a conversion epilogue: ``plain``, an existing decode
    epilogue's, over the converted words."""
    return lambda filled, t, scal: plain([word(filled[0])], t, scal)


# (colch, out_ch) -> K2's decode epilogue: the color and mono ones, then the
# conversions (a mono source replicated to R, G and B; a color source's green
# as the gray); each zeroes the pixels past n_pixels (the scalar). Words: 4
# channels the packed RGBA words, 3 the int32 words of the interleaved RGB
# stream, 1 the gray bytes, 2 uint16 gray | alpha << 8.
_EPILOGUES = {
    (3, 4): (engine.EPI_DEC4, torch.int32, _dec4, (1, 1)),
    (3, 3): (engine.EPI_DEC3, torch.int32, _dec3, (3, 4)),
    (1, 1): (engine.EPI_MONO1, torch.uint8, _mono1, (1, 1)),
    (1, 2): (engine.EPI_MONO2, torch.uint16, _mono2, (1, 1)),
    (1, 4): (engine.EPI_GRAY4, torch.int32, _converted(_dec4, _gray_word),
             (1, 1)),
    (1, 3): (engine.EPI_GRAY3, torch.int32, _converted(_dec3, _gray_word),
             (3, 4)),
    (3, 1): (engine.EPI_GREEN1, torch.uint8, _converted(_mono1, _green_word),
             (1, 1)),
    (3, 2): (engine.EPI_GREEN2, torch.uint16,
             _converted(_mono2, _green_word), (1, 1)),
}


def _epilogue(colch: int, out_ch: int) -> engine.Epilogue:
    """K2's decode epilogue for a source of ``colch`` color channels (3, or
    1 for mono: gray in packed byte 0, alpha in byte 3) decoded to
    ``out_ch`` channels."""
    kind, dtype, plain, units = _EPILOGUES[(colch, out_ch)]
    return engine.Epilogue(kind, dtype, plain, units)


def _emit(keys, pays, totals, n_pixels, n_out: int, colch: int, out_ch: int,
          every_row: bool = False):
    """K2 over one op stream (keys (B, Mc) int32 pixel offsets, pays the
    packed pixel of each, totals (B,), n_pixels (B, 1) int32) with the
    epilogue of (colch, out_ch): the epilogue's words (B, n_out * out_ch)
    bytes long. A conversion, or any pair with ``every_row``, counts its rows
    under ``codec.emit.rows`` and launches in the span ``codec.emit_pixels``
    (``rows``, ``colch``, ``out_ch``, ``n_max``)."""
    epi = _epilogue(colch, out_ch)
    args = (keys, [pays], totals, n_pixels, n_out, (_INIT_PACKED,), epi)
    if not (every_row or epi.kind in engine.CONVERSIONS):
        return engine.place_emit(*args)
    rows = keys.shape[0]
    trace.count("codec.emit.rows", rows)
    with trace.span("codec.emit_pixels", rows=rows, colch=colch,
                    out_ch=out_ch, n_max=n_out):
        return engine.place_emit(*args)


def _as_emitted(words, colch: int, out_ch: int, emit: str):
    """K2's words as ``emit`` asks: "u8" their flat interleaved bytes;
    "words" an array whose little-endian bytes are that stream (the words
    themselves for a mono source at 1/2 channels, else their int32 view)."""
    if emit == "u8":
        return words.view(torch.uint8)
    if colch == 1 and out_ch <= 2:
        return words
    return words.view(torch.int32)


def decode_stream_batched(data, chunks_len, n_pixels, *, colch: int,
                          out_ch: int, n_max: int, emit: str = "u8",
                          src_alpha: bool = True):
    """Decode a batch of SQOA (non-compat) streams.

    data: (B, M) uint8; chunks_len (stream length less the end marker) and
    n_pixels: (B,) int32; n_max: pixel slots per row (>= n_pixels, a
    multiple of 4). Returns (pixels, has_ref (B,) bool): pixels are flat
    interleaved uint8 (B, n_max * out_ch), or with emit="words" an array
    whose little-endian bytes are that stream (int32 (B, n_max * out_ch //
    4) for color, uint8/uint16 (B, n_max) for mono sources at 1/2
    channels). Rows with has_ref set need the host decoder."""
    if emit not in ("u8", "words"):
        raise ValueError(f"emit {emit!r}")
    if colch not in (1, 3) or out_ch not in (1, 2, 3, 4):
        raise ValueError("colch must be 1 or 3 and out_ch 1 to 4")
    mode = "mono" if colch == 1 else ("alpha" if src_alpha else "noalpha")
    keys, pays, totals, ref = frontend.decode_front_compact(
        data, chunks_len, n_max, mode=mode)
    npx = n_pixels.to(device=data.device, dtype=torch.int32)[:, None]
    words = _emit(keys, pays, totals, npx, n_max, colch, out_ch)
    return _as_emitted(words, colch, out_ch, emit), ref != 0


def decode_stream(data, chunks_len: int, n_pixels: int, *, colch: int,
                  out_ch: int, n_max: int, emit: str = "u8",
                  src_alpha: bool = True):
    """Single-stream decode: (M,) uint8 -> (the row of
    decode_stream_batched's pixels for ``emit``, has_ref bool tensor). The
    JAX package has a second form of this with rank-1 internals for large
    images (``decode_stream_flat``), which answers a TPU layout; here
    ``parallel.tiled.decode_large`` calls this one."""
    dev = data.device
    out, has_ref = decode_stream_batched(
        data[None, :],
        torch.tensor([chunks_len], dtype=torch.int32, device=dev),
        torch.tensor([n_pixels], dtype=torch.int32, device=dev),
        colch=colch, out_ch=out_ch, n_max=n_max, emit=emit,
        src_alpha=src_alpha,
    )
    return out[0], has_ref[0]


def decode_stream_packed(data, seg_lens, *, colch: int, out_ch: int,
                         seg: int, seg_px: int, src_alpha: bool = True):
    """Segment-packed decode of small same-size images (the icon class).

    Each row of ``data`` (B, M) uint8 carries M/seg images: image j fills
    bytes [j*seg, (j+1)*seg) with its whole stream, header included,
    zero-padded, and must decode to EXACTLY seg_px pixels (a multiple of
    4). seg_lens: (B, M/seg) int32, each image's stream length less the end
    marker (0: an empty segment; its pixels repeat the image before).
    K1 in segment mode gives one op stream per row with global keys, K2
    places it over the row's n_out = (M/seg) * seg_px pixels. Returns
    (words, has_ref (B,) bool, per packed ROW: one REF or foreign image
    sends its row mates to the host decoder too). ``words`` is the
    emit="words" layout of decode_stream_batched over the row's pixels:
    int32 (B, n_out * out_ch // 4) for a color source at 3/4 channels,
    uint8/uint16 (B, n_out) for a mono source at 1/2, else the int32 view
    of the interleaved bytes; image j starts at byte j * seg_px * out_ch."""
    if colch not in (1, 3) or out_ch not in (1, 2, 3, 4):
        raise ValueError("colch must be 1 or 3 and out_ch 1 to 4")
    bsz, m = data.shape
    if seg_px <= 0 or seg_px % 4:
        raise ValueError("seg_px must be a positive multiple of 4")
    n_out = (m // seg) * seg_px
    mode = "mono" if colch == 1 else ("alpha" if src_alpha else "noalpha")
    keys, pays, totals, ref = frontend.decode_front_compact(
        data, seg_lens, n_out, mode=mode, seg=seg, seg_px=seg_px)
    npx = torch.full((bsz, 1), n_out, dtype=torch.int32, device=data.device)
    words = _emit(keys, pays, totals, npx, n_out, colch, out_ch)
    return _as_emitted(words, colch, out_ch, "words"), ref != 0
