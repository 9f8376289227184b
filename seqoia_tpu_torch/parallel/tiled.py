"""Large single images (100-400 Mpx) on a card or a mesh of devices.

Port of ``seqoia_tpu/parallel/tiled.py``. On one device ``encode_large``
and ``decode_large`` take its one-device branches: the raw bytes go up
once, K4 expands them to packed pixels, K3 and K2 encode (K1 and K2
decode), and the stream (the pixels) comes back through
``utils.transfer.fetch_flat``. Given a mesh (``parallel.mesh``) of more
than one entry they run the shard forms below over it, one shard an
entry: the port has no partitioner, so the carried state crosses the
shard boundaries explicitly where the JAX package lets GSPMD partition
its scans.

Pinned memory: on a card the decoders return their pixels as a view of the
pinned (page-locked) buffer they arrived in, ``n_pixels * channels`` bytes
(0.4 GB for a 134 Mpx RGB image, 1.6 GB for 400 Mpx RGBA), which stays
locked for as long as the caller keeps the array; ``pixels.copy()`` gives a
pageable one. The functions do not copy themselves: on an H100 host that
copy (first touch of fresh pages) took several times the whole decode
(``PERF.md``). ``encode_large`` returns ``bytes``, a copy.

``encode_large_shardmap`` and ``decode_large_shardmap`` cut the image into
``n_shards`` ranges that are coded independently, with the codec state
that crosses a boundary carried explicitly: a host prepass finds it (the
pixel before the shard, the run in progress, which shard ends the image;
for the decode an op-aligned byte range per shard from one native token
hop). The JAX package runs one shard per device under ``shard_map``. Here
``mesh=`` gives one shard per mesh entry, and the shards of one device run
as the rows of one batch there; without a mesh all ``n_shards`` rows run
on ``device=``. Results are byte-identical to the unsharded functions at
any shard count and mesh.

Offsets on the card are int32 (keys, byte positions, pixel slots), so a
stream buffer or a worst-case output past 2**31 - 1 bytes raises
``ValueError`` instead of wrapping; every image the format allows (at most
400 M pixels) encodes below that.

QOI-compat (``.qoi``) images go to the native codec, as in the JAX package
(the index table is sequential state).

Spans (``utils.trace``; on while ``trace.enable()`` is in force or a
``torch.profiler`` session records): each function opens its root
``api.<name>``. Under it ``parallel.stage.fill`` (the host staging buffer
and the copy into it), ``parallel.stage.dispatch`` (the copy up and the
kernels' enqueue), ``parallel.wait`` at every host block on the card, its
``why`` the value waited for (``exact_total``: K2's size from K3's totals;
``total``: the stream's length; ``fetch``: the copy down; ``has_ref``: K1's
flags; ``totals``: the shards' lengths), ``parallel.fetch`` (the copy down,
its wait a child) and ``parallel.file_bytes`` (the header and body copied
into ``bytes``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native, spec
from .._device import resolve
from ..codec import decode_v2, encode_v2
from ..codec.encode import normalize_pixels_packed
from ..ops import pack
from ..utils import trace, transfer
from .mesh import default_mesh

INT32_LIMIT = 2**31 - 1
_INIT_PACKED = decode_v2._INIT_PACKED
_TILE = pack.TILE


def _pad_to(x, mult):
    return -(-int(x) // mult) * mult


def _require_int32(what: str, value: int) -> None:
    if value > INT32_LIMIT:
        raise ValueError(
            f"{what} is {value}, past the int32 offsets of the kernels "
            f"(limit {INT32_LIMIT})")


def _header(data):
    if len(data) < spec.HEADER_SIZE + spec.PADDING_SIZE:
        return None
    return spec.unpack_header(bytes(data[: spec.HEADER_SIZE + 1]) + b"\0" * 8)


def _host_decode(data, channels):
    pix, d = native.decode(bytes(data), channels)
    return (pix, spec.SqoaDesc(*d)) if pix is not None else (None, None)


def _out_channels(desc, channels):
    return channels if channels else desc.col_channels + int(desc.has_alpha)


def _i32(values, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.int32)).to(dev)


def _stage(nbytes: int, dev) -> torch.Tensor:
    """A zeroed host staging buffer, pinned when the target is a card (the
    caller fills it in its ``parallel.stage.fill`` span)."""
    return torch.zeros(nbytes, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")


def _file_bytes(desc, body: np.ndarray) -> bytes:
    """Header + stream body as one bytes object, the body copied once."""
    with trace.span("parallel.file_bytes", bytes=body.size):
        return b"".join([spec.pack_header(desc), memoryview(body)])


def _shard_mesh(device, mesh, n_shards: int) -> tuple:
    """The entries the shards run on, one a shard: the mesh, or ``device``
    ``n_shards`` times."""
    if mesh is not None:
        return default_mesh(mesh)
    if n_shards < 1:
        raise ValueError("n_shards must be at least 1")
    return (resolve(device),) * n_shards


def _by_device(mesh) -> list:
    """[(device, [shard indices])], the devices in order of first entry."""
    groups: dict = {}
    for s, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(s)
    return list(groups.items())


def _rows(host: torch.Tensor, idx: list) -> torch.Tensor:
    """Rows ``idx`` of a (shards, width) host tensor: a view when they are
    consecutive (the pinned buffer itself), else a copy."""
    if idx == list(range(idx[0], idx[-1] + 1)):
        return host[idx[0]: idx[-1] + 1]
    return host[idx]


def _fetch_in_order(pieces) -> np.ndarray:
    """Rank-1 tensors, on one device or several, concatenated in order on
    the host, with one copy down a device."""
    devs = list(dict.fromkeys(p.device for p in pieces))
    if len(devs) == 1:
        return transfer.fetch_flat(torch.cat(pieces))
    parts = {}
    for d in devs:
        mine = [p for p in pieces if p.device == d]
        host = transfer.fetch_flat(torch.cat(mine))
        cuts = np.cumsum([p.numel() for p in mine])[:-1]
        parts[d] = iter(np.split(host, cuts))
    return np.concatenate([next(parts[p.device]) for p in pieces])


@trace.entry_point("api.encode_large")
def encode_large(pixels, desc: spec.SqoaDesc, device="cuda",
                 mesh=None) -> bytes | None:
    """Encode one large image on ``device``, or with its pixels sharded over
    a mesh of more than one entry (``encode_large_shardmap``). Returns the
    file bytes, or None on invalid arguments."""
    mesh = default_mesh(mesh) if mesh is not None else None
    dev = mesh[0] if mesh is not None else resolve(device)
    if pixels is None or not spec.validate_encode_desc(desc):
        return None
    if desc.qoi_compat:
        return native.encode(
            np.asarray(pixels, np.uint8).ravel(), desc.width, desc.height,
            desc.channels, desc.colorspace, 1)
    if mesh is not None and len(mesh) > 1:
        return encode_large_shardmap(pixels, desc, mesh=mesh)
    n = desc.n_pixels
    n_pad = _pad_to(n, _TILE)
    worst = _pad_to(n_pad * (desc.norm_channels + 1) + spec.PADDING_SIZE + 1,
                    4096)
    _require_int32("the worst-case stream size", worst)
    packed = pack.normalize_pixels_device(pixels, desc, device=dev)
    # one K3 and one K2: K2's output is sized from K3's exact total
    out, total = encode_v2.encode_stream_flat(packed, n,
                                              colch=desc.col_channels)
    with trace.span("parallel.wait", why="total"):
        total = int(total)
    return _file_bytes(desc, transfer.fetch_flat(out, total))


def _last_anchor(packed: np.ndarray, end: int) -> int:
    """The last index <= end whose pixel differs from the one before it (the
    initial pixel before index 0), or -1: searched backwards in growing
    windows, so a boundary costs the length of the run that crosses it."""
    hi, step = end + 1, 4096
    while hi > 0:
        lo = max(hi - step, 0)
        cur = packed[lo:hi]
        prev = np.empty_like(cur)
        prev[1:] = cur[:-1]
        prev[0] = packed[lo - 1] if lo else _INIT_PACKED
        hits = np.flatnonzero(cur != prev)
        if hits.size:
            return lo + int(hits[-1])
        hi, step = lo, step * 4
    return -1


@trace.entry_point("api.encode_large_shardmap")
def encode_large_shardmap(pixels, desc: spec.SqoaDesc, n_shards: int = 4,
                          device="cuda", mesh=None) -> bytes | None:
    """encode_large with the pixels cut into ``n_shards`` ranges (with
    ``mesh=``: one a mesh entry) that encode independently, the ranges of
    one device as rows of one batch.

    The state at a boundary is exact and tiny: the pixel before it, the
    length mod 512 of the run in progress (BIGRUN phase and pending flush,
    seqoia.h:544-561) and which shard ends the image. The shards' streams
    concatenate into the byte-exact whole because a run that crosses a
    boundary flushes at the next change pixel, which lies in the next shard
    (seqoia.h:554-561)."""
    mesh = _shard_mesh(device, mesh, n_shards)
    if pixels is None or not spec.validate_encode_desc(desc):
        return None
    if desc.qoi_compat:
        return encode_large(pixels, desc, device=mesh[0])
    n_shards = len(mesh)
    n = desc.n_pixels
    n_pad = _pad_to(max(n, n_shards), n_shards * _TILE)
    chunk = n_pad // n_shards
    worst = _pad_to(chunk * (desc.norm_channels + 1) + spec.PADDING_SIZE + 1,
                    4096)
    _require_int32("a shard's worst-case stream size", worst)
    with trace.span("parallel.stage.fill", bytes=4 * n_pad):
        host = torch.zeros(n_pad, dtype=torch.int32,
                           pin_memory=mesh[0].type == "cuda")
        packed = host.numpy()
        packed[:n] = normalize_pixels_packed(pixels, desc)

    # --- host prepass: the exact state at every boundary --------------------
    init_prev = np.full(n_shards, _INIT_PACKED, np.int32)
    run_in = np.zeros(n_shards, np.int32)
    for s in range(1, n_shards):
        b = s * chunk
        if b <= n:
            init_prev[s] = packed[b - 1]
            run_in[s] = (b - 1 - _last_anchor(packed, b - 1)) % spec.SQOA_MAXRUN
    n_local = np.clip(n - chunk * np.arange(n_shards), 0, chunk)
    last_shard = max(0, -(-n // chunk) - 1)
    emit_tail = np.arange(n_shards) == last_shard

    pieces = [None] * n_shards
    for dev, idx in _by_device(mesh):
        with trace.span("parallel.stage.dispatch", device=str(dev),
                        rows=len(idx)):
            rows = _rows(host.view(n_shards, chunk), idx).to(
                dev, non_blocking=True)
            ip, ri, nv, et = (_i32(a[idx], dev)
                              for a in (init_prev, run_in, n_local,
                                        emit_tail))
            outs, tots = encode_v2.encode_stream_batched(
                rows, nv, colch=desc.col_channels, init_prev=ip, run_in=ri,
                emit_tail=et)
        with trace.span("parallel.wait", why="totals"):
            tots = tots.tolist()
        for r, t in enumerate(tots):
            pieces[idx[r]] = outs[r, :t]
    return _file_bytes(desc, _fetch_in_order(pieces))


@trace.entry_point("api.decode_large")
def decode_large(data: bytes, channels: int = 0, device="cuda", mesh=None):
    """Decode one large SQOA stream: K1, then K2 with the pixels emitted as
    words; over a mesh of more than one entry, ``decode_large_shardmap``.
    Returns (flat uint8 pixels, SqoaDesc) or (None, None); on a card the
    pixels are a view of a pinned buffer (module docstring). A stream with
    REF ops (which no SQOA encoder emits) goes to the native codec."""
    if mesh is not None:
        mesh = default_mesh(mesh)
        if len(mesh) > 1:
            return decode_large_shardmap(data, channels, mesh=mesh)
        device = mesh[0]
    dev = resolve(device)
    desc = _header(data)
    if desc is None or channels < 0 or channels > 4:
        return None, None
    if desc.qoi_compat:
        return _host_decode(data, channels)
    colch = desc.col_channels
    out_ch = _out_channels(desc, channels)
    m_pad = _pad_to(len(data), _TILE)
    _require_int32("the stream buffer", m_pad)
    with trace.span("parallel.stage.fill", bytes=m_pad):
        buf = _stage(m_pad, dev)
        buf.numpy()[: len(data)] = np.frombuffer(data, np.uint8)
    n_max = _pad_to(desc.n_pixels, _TILE)

    with trace.span("parallel.stage.dispatch", device=str(dev)):
        out, has_ref = decode_v2.decode_stream(
            buf.to(dev, non_blocking=True), len(data) - spec.PADDING_SIZE,
            desc.n_pixels, colch=colch, out_ch=out_ch, n_max=int(n_max),
            emit="words", src_alpha=bool(desc.has_alpha))
    with trace.span("parallel.wait", why="has_ref"):
        has_ref = bool(has_ref)
    if has_ref:
        return _host_decode(data, channels)
    n_out = desc.n_pixels * out_ch
    host = transfer.fetch_flat(out, -(-n_out // out.element_size()))
    return host.view(np.uint8)[:n_out], desc


def _lanes(out_ch: int):
    """Channel lanes of the interleaved output, in the decode's emit order:
    (the leading lanes that carry color, or a mono source's gray replicated,
    and the alpha lane or None)."""
    return (1 if out_ch <= 2 else 3), (out_ch - 1 if out_ch in (2, 4) else None)


@trace.entry_point("api.decode_large_shardmap")
def decode_large_shardmap(data: bytes, channels: int = 0, n_shards: int = 4,
                          device="cuda", mesh=None):
    """decode_large with the stream cut into ``n_shards`` (with ``mesh=``:
    one a mesh entry) op-aligned byte ranges that decode independently, the
    ranges of one device as rows of one batch.

    One native token hop (``native.scan_chunks``: op lengths and pixel
    counts, no values) finds the ranges; the alpha modifier is consumed with
    its op (seqoia.h:777-783), so every boundary is a clean decoder entry.
    Each row decodes as a fresh stream; the only state it lacks, the pixel
    carried into it (seqoia.h:716-719), is an additive delta per channel
    on the pixels before the row's first absolute anchor (RGB/RGBA op),
    chained from row to row (and device to device) and applied on the
    card before the one copy back a device. REF, malformed and compat
    streams, and those K1 flags, go to the sequential paths."""
    mesh = _shard_mesh(device, mesh, n_shards)
    desc = _header(data)
    if desc is None or channels < 0 or channels > 4:
        return None, None
    n_shards = len(mesh)
    colch = desc.col_channels
    out_ch = _out_channels(desc, channels)
    # a color stream forced to gray drops r and b, so the pixel carried
    # across a boundary cannot be rebuilt from the output
    if desc.qoi_compat or n_shards == 1 or (colch == 3 and out_ch < 3):
        return decode_large(data, channels, device=mesh[0])
    n = desc.n_pixels
    chunks = native.scan_chunks(bytes(data), n_shards)
    if chunks is None:
        return _host_decode(data, channels)
    byte_pos, px_start, anch_r, anch_a = (chunks[:, c] for c in range(4))
    ends = np.append(byte_pos[1:], len(data) - spec.PADDING_SIZE)
    counts = np.append(px_start[1:], n) - px_start
    shard_lens = ends - byte_pos

    start = spec.HEADER_SIZE + 1
    pad = spec.PADDING_SIZE
    m_pad = _pad_to(start + int(shard_lens.max()) + pad, _TILE)
    _require_int32("a shard's stream buffer", m_pad)
    raw = np.frombuffer(data, np.uint8)
    with trace.span("parallel.stage.fill", bytes=n_shards * m_pad):
        host = _stage(n_shards * m_pad, mesh[0]).view(n_shards, m_pad)
        rows = host.numpy()
        # each row is followed by the 8 bytes that follow its range in the
        # stream, as every decode stages its stream: the end marker after
        # the row that ends the stream, where the reference peeks for an
        # alpha modifier after the last op (seqoia.h:777-783)
        for s in range(n_shards):
            rows[s, start: start + shard_lens[s] + pad] = \
                raw[byte_pos[s]: ends[s] + pad]
    n_max = _pad_to(max(int(counts.max()), 1), _TILE)

    outs, refs = [None] * n_shards, []
    for dev, idx in _by_device(mesh):
        with trace.span("parallel.stage.dispatch", device=str(dev),
                        rows=len(idx)):
            out, ref = decode_v2.decode_stream_batched(
                _rows(host, idx).to(dev, non_blocking=True),
                _i32((start + shard_lens)[idx], dev), _i32(counts[idx], dev),
                colch=colch, out_ch=out_ch, n_max=int(n_max),
                src_alpha=bool(desc.has_alpha))
        refs.append(ref)
        for r, s in enumerate(idx):
            outs[s] = out[r]
    # a row K1 flags (an RGB stream with an alpha modifier or an RGBA op)
    # goes whole to the native codec, as in decode_large
    with trace.span("parallel.wait", why="has_ref"):
        has_ref = any(bool(r.any()) for r in refs)
    if has_ref:
        return _host_decode(data, channels)

    # --- chained head fix-ups: add the carried pixel to every row's head ----
    n_color, alpha_lane = _lanes(out_ch)
    prev = torch.tensor([0, 0, 0, 255], dtype=torch.uint8, device=mesh[0])
    pieces = []
    for s in range(n_shards):
        cnt = int(counts[s])
        px = outs[s][: cnt * out_ch].view(cnt, out_ch)
        prev = prev.to(px.device)
        if cnt:
            k_r = int(anch_r[s] - px_start[s]) if anch_r[s] >= 0 else cnt
            # mono carries its gray in g; uint8 adds wrap mod 256
            px[:k_r, :n_color] += prev[:3] if colch == 3 else prev[1:2]
            if alpha_lane is not None:
                k_a = int(anch_a[s] - px_start[s]) if anch_a[s] >= 0 else cnt
                px[:k_a, alpha_lane] += prev[3] + 1  # prev - 255
            last = px[cnt - 1]
            if colch == 3:
                prev[:3] = last[:3]
            else:
                prev[1] = last[0]
            if alpha_lane is not None:
                prev[3] = last[alpha_lane]
        pieces.append(px.reshape(-1))
    return _fetch_in_order(pieces)[: n * out_ch], desc
