"""Batched multi-image decode and encode on a card or a mesh of devices.

Port of ``seqoia_tpu/parallel/batch.py`` (``DecodeResult``,
``BatchDecoder``, ``corpus_decode``, ``BatchEncoder``, ``corpus_encode``).

Both coders run one pipeline (``_Pipeline``). A call groups its images into
classes. With ``mesh=`` (``parallel.mesh``) each class is split into
contiguous parts, one per mesh entry (``batch_sharding``), and each part is
staged and coded on its entry's device as a class of its own; without a
mesh everything runs on ``device=`` (the JAX package's default mesh is
every device). Results come back in input order. A class's kernels and the
copy of its outputs into pinned host memory (on a second stream of its
device) are queued, and the host goes on staging the next class; results
are unpacked class by class as their copies complete. Device bytes held by
queued work are bounded (``max_outstanding_bytes``): past the bound the
oldest class drains first. A ``torch.cuda.OutOfMemoryError`` (PyTorch
raises it where a class is dispatched, at an allocation) drains the queue
and re-runs the class at half size, down to a single image; one that still
does not fit comes back as that image's error slot (decode) or None
(encode, counted in ``last_stats["oom_errors"]``). Work the card fails at
is never moved to the host: the native codec decodes only the rows the
policy and the REF streams send it. No reference cycle holds a call's
results: reference counting alone frees them (the garbage collector may
run late).

Decode: streams are grouped into shape classes, each class is stacked and
decoded by one batched call, and a malformed header is refused on the host
before dispatch and comes back as that image's error slot instead of
failing the batch (per-image failure isolation). Routes, per class:

* SQOA, at least two images of exactly ``n_max`` pixels with stream bucket
  and pixel bucket at most 8192 (the icon class): segment-packed rows of
  32768 bytes through ``decode_v2.decode_stream_packed`` (K1 in segment
  mode, K2 over the row's pixels);
* other SQOA classes: ``decode_v2.decode_stream_batched`` (K1, K2);
* ``.qoi``, color and mono, by the policy ``SEQOIA_COMPAT_CUDA`` read at
  each call (``_compat_mode``): ``1`` (the default) every stream through
  ``decode_compat.decode_stream_compat_batched``, which keeps every row on
  the card; ``0`` every stream to the host pool (the JAX package's
  default); ``auto`` a color stream to the card when
  ``native.compat_probe`` predicts an INDEX-chain depth below the
  fixpoint's cap (``decode_compat._MAX_ITERS``), else to the host pool,
  counted in ``last_stats["auto_cuda"]`` / ``["auto_host"]``, and mono
  streams to the host pool, as the JAX package's ``auto`` does;
* the host pool: the native codec on a pool of host threads. It takes the
  ``.qoi`` streams the policy sends it, on a background thread while the
  card's classes run (inline when nothing was dispatched or the host has
  one core), then the rows the card hands back (SQOA streams with REF
  ops); all counted in ``last_stats["host_rows"]``.

The host work of a batch of many small streams is done once a batch where
the data allows. A stream's first 15 bytes (the 14-byte header and the
start byte, whose absence marks ``.qoi``) alone decide its desc and its
class but for the stream bucket, so a call parses each distinct header
once: a dict, kept for the call only, maps those bytes to the parse (None
for a malformed header), and only the stream bucket is reckoned a stream.
Each result still gets a desc object of its own. ``pack_segments`` fills
the packed rows through one memoryview, one slice assignment a stream. A
class with no flagged row and one pixel count (every packed class) gets
its results from one list of row views; any other class goes image by
image, and a flagged packed row sends its images to the host pool.

Encode: images are grouped by (color channels, alpha, ``.qoi``, pixel
bucket); each class's raw bytes are staged once into a pinned buffer and
copied up, K4 packs them (strides 1-3; stride 4 is already packed), and one
front (K3, or the ``.qoi`` front: K8, K7, K5) and one K2 encode the class,
K2 sized from the exact stream totals the front computed
(``encode_v2.encode_stream_batched``). Reading those totals waits for the
class's front, so the host stages the next class once that front has run.
An image whose pixels are None or whose desc is invalid gets None.

Spans (``utils.trace``; on while ``trace.enable()`` is in force or a
``torch.profiler`` session records, then also ``seqoia/<name>`` ranges in
the profile): a call is the root ``api.batch_decode`` (``images``,
``classes``) or ``api.batch_encode``. Under it, per class dispatched,
``parallel.class`` (``key``, ``rows``, ``in_bytes``, ``out_bytes``,
``device``) holds ``parallel.stage.fill`` (the pinned staging buffer and
the copies into it) and ``parallel.stage.dispatch`` (the copy up and the
codec's enqueue, with the codec's own spans: the ``.qoi`` fixpoint's
passes, the encode's wait for its exact totals); before them, a decode's
``parallel.classify`` (``images``, ``classes``: each header read and the
streams grouped into classes, outside ``last_timings``; counted always:
``parallel.classify.header_parses``, one a distinct header parsed, and
``parallel.classify.header_hits``, one a stream whose header the call had
already parsed); per class unpacked,
``parallel.wait`` (``why``: ``first`` for the first class, ``unpack`` for
each; ``key``) and ``parallel.unpack.copy`` (the copy out of pinned memory
and the results; ``reused``: whether the class's host array came from the
decoder's pool); ``parallel.host_pool`` around host decodes the caller
runs or waits for (the pool's thread opens no span).

Where a decode's results live: each class's output is copied, in one copy,
out of pinned memory (on the CPU, out of the output tensor) into an
ordinary pageable numpy array, and the class's images are views of it.
``BatchDecoder`` keeps the arrays it handed out in its last two calls and
gives a class the smallest of them that is large enough and free: nothing
else refers to it, no result, view of one, ``torch.from_numpy`` or
``memoryview`` (a numpy view refers to the array that owns its memory).
Pages written before take a copy several times faster than new ones,
which a new array over glibc's 32 MiB mmap cap always gets, each faulted
in by the kernel as it is first written. A caller that keeps each call's
results until the next call returns, as a loader does, has by then let go
of the call before last: its array is free. Otherwise the class gets a new
array. Counted always: ``parallel.unpack.reuse`` and
``parallel.unpack.fresh``, one a class, and for each icon class on the
packed route its images under ``parallel.packed.images`` and its packed
rows under ``parallel.packed.rows``, and for each class with a gray source
(SQOA or ``.qoi``, on either route) its images under
``parallel.mono.images``. The decoder holds at most the output of its last
two calls, one of which such a caller holds anyway.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native, spec
from .._device import resolve
from ..codec import decode_compat, decode_v2, encode_v2
from ..codec.encode import pixel_bucket
from ..ops import pack
from ..utils import trace
from .mesh import batch_sharding, default_mesh

#: default bound on device bytes held by dispatched work that was not
#: fetched yet (inputs + outputs)
_MAX_OUTSTANDING = 6 << 30

#: a packed row holds 32768 bytes of segments, as in the JAX package
_ROW_BYTES = 32768
#: the icon class: stream and pixel buckets up to this take the packed route
_ICON_MAX = 8192
#: K1's segment contract: a segment is a multiple of 128 bytes
_SEG_MIN = 128
#: the route of .qoi streams when SEQOIA_COMPAT_CUDA is unset: the card.
#: On an H100 host with 8 cores the host pool won on 32 1024x1024 photos
#: (5.7x) and lost on 8192 64x64 icons (3.8x), so the JAX package's
#: default, the host, was not taken (PERF.md)
_COMPAT_DEFAULT = "1"


def _compat_mode() -> str:
    """The batch route of ``.qoi`` streams, ``SEQOIA_COMPAT_CUDA`` read at
    each call: ``1`` the card, ``0`` the host pool, ``auto`` by probe
    (module docstring); unset or empty: ``_COMPAT_DEFAULT``."""
    mode = os.environ.get("SEQOIA_COMPAT_CUDA", "") or _COMPAT_DEFAULT
    if mode not in ("0", "1", "auto"):
        raise ValueError(f"SEQOIA_COMPAT_CUDA={mode!r}: use 0, 1 or auto")
    return mode


def _refs(arrays: list, k: int) -> int:
    """References to ``arrays[k]``: ``_ALONE`` where the list is its only
    owner."""
    return sys.getrefcount(arrays[k])


_ALONE = _refs([np.empty(0)], 0)


def _next_pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _classify_header(head: bytes, channels: int):
    """What a stream's class takes from its 15 header bytes, which alone
    decide it: (the desc's fields, the class key before the stream bucket,
    the key after it), or None for a malformed header or ``channels``."""
    desc = spec.unpack_header(head + b"\0" * spec.PADDING_SIZE)
    if desc is None or channels < 0 or channels > 4:
        return None
    colch = desc.col_channels
    out_ch = channels if channels else colch + int(desc.has_alpha)
    # power-of-two buckets keep the classes few; no kernel of the port needs
    # a floor on the stream bucket, K2 needs the pixel slots to be a
    # multiple of 4
    return (dataclasses.astuple(desc),
            (colch, bool(desc.qoi_compat), out_ch),
            (_next_pow2(max(desc.n_pixels, 4)), bool(desc.has_alpha)))


def pack_segments(streams, seg: int, pin: bool = False):
    """The streams of one icon class as packed rows: ((rows, 32768) uint8
    with stream j in segment j % k of row j // k, k = 32768 // seg, and the
    (rows, k) int32 segment lengths (stream length less the end marker; 0
    for the empty segments after the last stream). ``pin``: in pinned host
    memory. A stream is any 1-D buffer of bytes (``bytes``, ``bytearray``,
    ``memoryview``, uint8 ``np.ndarray``)."""
    k = _ROW_BYTES // seg
    n = len(streams)
    rows = -(-n // k)
    buf = torch.zeros((rows, _ROW_BYTES), dtype=torch.uint8, pin_memory=pin)
    slens = torch.zeros((rows, k), dtype=torch.int32, pin_memory=pin)
    slens.numpy().reshape(-1)[:n] = (
        np.fromiter(map(len, streams), np.int64, n) - spec.PADDING_SIZE)
    # segment j % k of row j // k starts at byte j * seg of the rows
    dst = memoryview(buf.numpy()).cast("B")
    for j, data in enumerate(streams):
        at = j * seg
        try:
            dst[at: at + len(data)] = data
        except (TypeError, ValueError):  # a buffer whose format is not "B"
            dst[at: at + len(data)] = memoryview(data).cast("B")
    return buf, slens


@dataclasses.dataclass
class DecodeResult:
    # flat uint8 (the images of one class are views of one array), or None
    # on error
    pixels: np.ndarray | None
    desc: spec.SqoaDesc | None
    error: str | None = None


@dataclasses.dataclass
class _Pending:
    """One dispatched class: its outputs on their way to ``host``."""
    items: list
    key: tuple
    host: tuple              # pinned (or CPU) copies of the outputs
    done: object             # event after the copies (None on the CPU)
    nbytes: int              # device bytes held: input + first output
    keep: tuple              # device tensors the queued copies read
    seg_k: int | None        # images per packed row, None off the icon route


class _Pipeline:
    """The pipeline both coders run (module docstring). A coder gives
    ``_run(items, key, dev)``, which stages and codes one class on ``dev``
    and returns (its output tensors, the bytes of its input, images per
    packed row or None); ``_finish``, which unpacks a ``_Pending`` into the
    results; and ``_unfit(item, results)``, the outcome of an image that
    alone does not fit in device memory. A call sets ``_stats``, with
    ``early_drains`` and ``oom_redispatch`` among its counts, runs
    ``_queue`` and then ``_drain``, with the same ``finish``."""

    def __init__(self, device="cuda", max_outstanding_bytes: int | None = None,
                 mesh=None):
        self.mesh = (default_mesh(mesh) if mesh is not None
                     else (resolve(device),))
        self.last_timings: dict = {}
        self.last_stats: dict = {}
        self.max_outstanding_bytes = (
            _MAX_OUTSTANDING if max_outstanding_bytes is None
            else int(max_outstanding_bytes))
        self._copy_streams: dict = {}   # per device, made once

    def _dispatch(self, items, key, dev) -> _Pending:
        """Stage and code one class on ``dev`` and queue the copy of its
        outputs on the device's copy stream."""
        with trace.span("parallel.class", key=key, rows=len(items),
                        device=str(dev)) as span:
            outs, in_bytes, seg_k = self._run(items, key, dev)
            out_bytes = outs[0].numel() * outs[0].element_size()
            span.set(in_bytes=in_bytes, out_bytes=out_bytes)
            nbytes = out_bytes + in_bytes
            if dev.type != "cuda":
                return _Pending(items, key, outs, None, nbytes, (), seg_k)
            copy = self._copy_streams.get(dev)
            if copy is None:
                copy = self._copy_streams[dev] = torch.cuda.Stream(dev)
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in outs)
            copy.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copy):
                for h, t in zip(host, outs):
                    h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy)
            return _Pending(items, key, host, done, nbytes, outs, seg_k)

    def _queue(self, classes, results, finish):
        """Dispatch each (key, items) of ``classes`` in ``batch_sharding``'s
        parts, in order. Past ``max_outstanding_bytes`` the oldest queued
        class is finished (``finish(entry)``) first. Returns the queue, the
        seconds spent staging and dispatching and those spent finishing
        early."""
        queue: list[_Pending] = []
        outstanding, t_early = 0, 0.0
        t0 = time.perf_counter()
        for key, items in classes:
            for dev, lo, hi in batch_sharding(self.mesh, len(items)):
                part = items[lo:hi]
                try:
                    entry = self._dispatch(part, key, dev)
                except torch.cuda.OutOfMemoryError:
                    # free the queue and its bytes, then run degraded
                    while queue:
                        finish(queue.pop(0))
                    outstanding = 0
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                    self._degrade(part, key, dev, results, finish)
                    continue
                queue.append(entry)
                outstanding += entry.nbytes
                while (outstanding > self.max_outstanding_bytes
                       and len(queue) > 1):
                    tf = time.perf_counter()
                    outstanding -= queue[0].nbytes
                    finish(queue.pop(0))
                    self._stats["early_drains"] += 1
                    t_early += time.perf_counter() - tf
        return queue, time.perf_counter() - t0 - t_early, t_early

    def _degrade(self, items, key, dev, results, finish):
        """Re-run a class that did not fit, at once (the queue has drained),
        halving it while it still does not fit; an image that alone does not
        fit goes to ``_unfit``. A stack of parts, first half first: each half
        runs after the ``except`` block of its parent's failure has ended,
        so the failed dispatch's frames, and the device memory they hold,
        are gone by then."""
        todo = [items]
        while todo:
            part = todo.pop()
            self._stats["oom_redispatch"] += 1
            try:
                entry = self._dispatch(part, key, dev)
            except torch.cuda.OutOfMemoryError:
                if len(part) == 1:
                    self._unfit(part[0], results)
                else:
                    half = len(part) // 2
                    todo += [part[half:], part[:half]]
            else:
                finish(entry)

    @staticmethod
    def _drain(queue, finish):
        """Wait for the first queued class (the compute not yet hidden),
        then finish the classes in order while later ones still run.
        Returns the seconds of the wait and of the rest."""
        t0 = time.perf_counter()
        if queue:
            with trace.span("parallel.wait", why="first", key=queue[0].key):
                if queue[0].done is not None:
                    queue[0].done.synchronize()
        t1 = time.perf_counter()
        while queue:
            finish(queue.pop(0))
        return t1 - t0, time.perf_counter() - t1


class BatchDecoder(_Pipeline):
    """Decode many SQOA / QOI streams on one card or a mesh (module
    docstring).

    ``last_timings`` holds the seconds of the latest call spent staging and
    dispatching (``stage``), waiting for the first class's output
    (``compute``), unpacking the outputs (``fetch``) and in host decodes
    that nothing overlapped (``host``); ``last_stats`` the early drains,
    OOM re-dispatches, packed rows, rows decoded on the host and, under
    ``SEQOIA_COMPAT_CUDA=auto``, the probed streams sent to the card and to
    the host."""

    def __init__(self, device="cuda", max_outstanding_bytes: int | None = None,
                 mesh=None):
        super().__init__(device, max_outstanding_bytes, mesh)
        # result memory (module docstring): the host arrays handed out, and
        # the number of the call that last handed out each
        self._pool: list[np.ndarray] = []
        self._pool_calls: list[int] = []
        self._pool_lock = threading.Lock()
        self._calls = 0

    # --- one class ---------------------------------------------------------

    def _result_memory(self, nbytes: int):
        """A host array of at least ``nbytes`` for one class's results:
        the smallest free one of the pool, else a new one; and whether it
        was reused."""
        with self._pool_lock:
            pool, best = self._pool, None
            for k in range(len(pool)):
                if (pool[k].nbytes >= nbytes and _refs(pool, k) <= _ALONE
                        and (best is None
                             or pool[k].nbytes < pool[best].nbytes)):
                    best = k
            if best is None:
                pool.append(np.empty(nbytes, np.uint8))
                self._pool_calls.append(self._calls)
                trace.count("parallel.unpack.fresh")
                return pool[-1], False
            self._pool_calls[best] = self._calls
            trace.count("parallel.unpack.reuse")
            return pool[best], True

    def _forget(self) -> None:
        """End a call: drop the arrays that neither it nor the call before
        handed out."""
        with self._pool_lock:
            keep = [k for k, c in enumerate(self._pool_calls)
                    if c >= self._calls - 1]
            self._pool = [self._pool[k] for k in keep]
            self._pool_calls = [self._pool_calls[k] for k in keep]
            self._calls += 1

    def _run(self, items, key, dev):
        """Decode one staged class on ``dev``. Returns ((output, per-row
        fallback flags), input bytes, images per packed row or None)."""
        colch, compat, out_ch, m_pad, n_max, src_alpha = key
        pin = dev.type == "cuda"
        if colch == 1:
            trace.count("parallel.mono.images", len(items))

        def up(t):
            return t.to(dev, non_blocking=True)

        if (not compat and len(items) >= 2 and _SEG_MIN <= m_pad <= _ICON_MAX
                and n_max <= _ICON_MAX
                and all(it[2].n_pixels == n_max for it in items)):
            with trace.span("parallel.stage.fill", packed=True):
                buf, slens = pack_segments([it[1] for it in items], m_pad,
                                           pin)
            with trace.span("parallel.stage.dispatch"):
                out, ref = decode_v2.decode_stream_packed(
                    up(buf), up(slens), colch=colch, out_ch=out_ch,
                    seg=m_pad, seg_px=n_max, src_alpha=src_alpha)
            self._stats["packed_rows"] += buf.shape[0]
            trace.count("parallel.packed.images", len(items))
            trace.count("parallel.packed.rows", buf.shape[0])
            return (out, ref), buf.numel(), _ROW_BYTES // m_pad
        b = len(items)
        with trace.span("parallel.stage.fill"):
            buf = torch.zeros((b, m_pad), dtype=torch.uint8, pin_memory=pin)
            meta = torch.zeros((2, b), dtype=torch.int32, pin_memory=pin)
            buf_np, meta_np = buf.numpy(), meta.numpy()
            for j, (_, data, desc) in enumerate(items):
                buf_np[j, : len(data)] = np.frombuffer(data, np.uint8)
                meta_np[0, j] = len(data) - spec.PADDING_SIZE
                meta_np[1, j] = desc.n_pixels
        with trace.span("parallel.stage.dispatch"):
            clens, npix = up(meta)
            if compat:
                out, _ = decode_compat.decode_stream_compat_batched(
                    up(buf), clens, npix, colch=colch, out_ch=out_ch,
                    n_max=n_max)
                ref = torch.zeros(b, dtype=torch.bool, device=dev)
            else:
                out, ref = decode_v2.decode_stream_batched(
                    up(buf), clens, npix, colch=colch, out_ch=out_ch,
                    n_max=n_max, emit="words", src_alpha=src_alpha)
        return (out, ref), buf.numel(), None

    def _finish(self, entry: _Pending, results, fallback) -> None:
        """Unpack one class's output into results; rows the card hands back
        go to ``fallback``."""
        with trace.span("parallel.wait", why="unpack", key=entry.key):
            if entry.done is not None:
                entry.done.synchronize()
        out_ch = entry.key[2]
        host, need_fb = entry.host
        nbytes = host.numel() * host.element_size()
        with trace.span("parallel.unpack.copy", key=entry.key,
                        bytes=nbytes) as span:
            # one copy out of the pinned buffer for the whole class into an
            # array of the decoder's pool; the images are views of it (a
            # copy per image costs thousands of small allocations, and
            # keeping the views on the pinned buffer would hold page-locked
            # memory for as long as the results live)
            src = host.numpy()
            mem, reused = self._result_memory(nbytes)
            span.set(reused=reused)
            out = mem[:nbytes].view(src.dtype).reshape(src.shape)
            np.copyto(out, src)
            rows = out.shape[0]
            out = out.view(np.uint8).reshape(rows, -1)  # words: a free view
            if entry.seg_k is not None:  # packed rows: one image a segment
                out = out.reshape(rows * entry.seg_k, -1)
            need_fb = need_fb.numpy()
            items = entry.items
            npix = items[0][2].n_pixels
            # the packed route takes only classes of one pixel count
            if not need_fb.any() and (entry.seg_k is not None or all(
                    it[2].n_pixels == npix for it in items)):
                views = list(out[: len(items), : npix * out_ch])
                for (i, _, desc), view in zip(items, views):
                    results[i] = DecodeResult(view, desc)
                return
            for j, (i, data, desc) in enumerate(items):
                # a packed row is flagged as a whole: one foreign image sends
                # its row mates to the same byte-exact host decoder
                if need_fb[j // entry.seg_k if entry.seg_k else j]:
                    fallback.append((i, data))
                else:
                    n = desc.n_pixels * out_ch
                    results[i] = DecodeResult(out[j, :n], desc)

    # --- the call ----------------------------------------------------------

    def __call__(self, streams, channels: int = 0):
        with trace.entry("api.batch_decode", images=len(streams)) as call:
            try:
                return self._decode(streams, channels, call)
            finally:
                self._forget()

    def _decode(self, streams, channels, call):
        results: list[DecodeResult | None] = [None] * len(streams)
        groups = defaultdict(list)
        # one parse a distinct header, for this call only (module docstring)
        headers: dict = {}
        hits = 0
        with trace.span("parallel.classify", images=len(streams)) as span:
            for i, data in enumerate(streams):
                n = len(data)
                if n < spec.HEADER_SIZE + spec.PADDING_SIZE:
                    results[i] = DecodeResult(None, None, "invalid header")
                    continue
                head = bytes(data[: spec.HEADER_SIZE + 1])
                if head in headers:
                    hits += 1
                    parsed = headers[head]
                else:
                    parsed = headers[head] = _classify_header(head, channels)
                if parsed is None:
                    results[i] = DecodeResult(None, None, "invalid header")
                    continue
                fields, front, back = parsed
                # the stream bucket is _next_pow2(n), n > 1 here; each
                # result keeps a desc of its own: a caller may edit it
                groups[front + (1 << (n - 1).bit_length(),) + back].append(
                    (i, data, spec.SqoaDesc(*fields)))
            span.set(classes=len(groups))
        trace.count("parallel.classify.header_hits", hits)
        trace.count("parallel.classify.header_parses", len(headers))
        call.set(classes=len(groups))

        stats = self._stats = {"early_drains": 0, "oom_redispatch": 0,
                               "packed_rows": 0, "host_rows": 0}
        mode = _compat_mode()
        host_items: list = []   # .qoi streams the policy sends to the host
        fallback: list = []     # rows the card hands back

        def finish(entry):
            self._finish(entry, results, fallback)

        # the policy takes its share of a .qoi class as the class comes up
        classes = ((key, self._route(items, key, mode, host_items, stats))
                   for key, items in groups.items())
        queue, t_stage, t_early = self._queue(classes, results, finish)

        # the host's share of .qoi streams: on a thread of its own while
        # the card's classes run, inline when there is nothing to overlap
        # or one core (a thread then only adds turns of the GIL)
        host_job, t_host = None, 0.0
        if host_items:
            pairs = [(i, data) for i, data, _ in host_items]
            if queue and (os.cpu_count() or 8) > 1:
                ex = ThreadPoolExecutor(1)
                host_job = ex.submit(self._host_pool, pairs, channels, results)
                ex.shutdown(wait=False)  # the job runs on; its thread ends
            else:
                t0 = time.perf_counter()
                with trace.span("parallel.host_pool", rows=len(pairs),
                                why="policy"):
                    self._host_pool(pairs, channels, results)
                t_host = time.perf_counter() - t0

        t_compute, t_fetch = self._drain(queue, finish)

        t0 = time.perf_counter()
        if fallback:
            with trace.span("parallel.host_pool", rows=len(fallback),
                            why="fallback"):
                self._host_pool(fallback, channels, results)
        if host_job is not None:
            # the pool's thread ran it beside the card: the caller's wait
            with trace.span("parallel.host_pool", rows=len(host_items),
                            why="policy_thread"):
                host_job.result()
        t_host += time.perf_counter() - t0
        stats["host_rows"] = len(fallback) + len(host_items)
        self.last_timings = {"stage": t_stage, "compute": t_compute,
                             "fetch": t_fetch + t_early, "host": t_host}
        self.last_stats = stats
        return results

    def _unfit(self, item, results):
        results[item[0]] = DecodeResult(None, None, "out of device memory")

    @staticmethod
    def _route(items, key, mode, host_items, stats):
        """The items of a class that go to the card: all of a SQOA class or
        under ``mode`` ``1``; of a ``.qoi`` class under ``0`` or ``auto``,
        the others join ``host_items``. ``auto`` sends a color stream to the
        card when its probed INDEX-chain depth is below the fixpoint's cap,
        and mono streams to the host."""
        colch, compat = key[0], key[1]
        if not compat or mode == "1":
            return items
        if mode == "0" or colch != 3:
            host_items.extend(items)
            return []
        cap = decode_compat._MAX_ITERS
        card = []
        for it in items:
            pr = native.compat_probe(bytes(it[1]))
            (card if pr is not None and pr[0] < cap else host_items).append(
                it)
        stats["auto_cuda"] = stats.get("auto_cuda", 0) + len(card)
        stats["auto_host"] = (stats.get("auto_host", 0) + len(items)
                              - len(card))
        return card

    @staticmethod
    def _host_pool(items, channels, results):
        """Decode (index, stream) pairs with the native codec on a pool of
        host threads (the ctypes call releases the GIL)."""
        def host_decode(arg):
            i, data = arg
            pix, d = native.decode(bytes(data), channels)
            if pix is None:
                return i, DecodeResult(None, None, "malformed stream")
            return i, DecodeResult(pix, spec.SqoaDesc(*d))

        workers = min(len(items), os.cpu_count() or 8)
        if workers <= 1:
            for it in items:
                i, r = host_decode(it)
                results[i] = r
            return
        with ThreadPoolExecutor(workers) as ex:
            for i, r in ex.map(host_decode, items):
                results[i] = r


def corpus_decode(streams, channels: int = 0, device="cuda", mesh=None):
    return BatchDecoder(device, mesh=mesh)(streams, channels)


class BatchEncoder(_Pipeline):
    """Encode many images on one card or a mesh (module docstring); returns
    a list of file bytes, None for an image that is None, has an invalid
    desc or did not fit in device memory.

    ``last_timings`` holds the seconds of the latest call spent staging and
    dispatching (``stage``), waiting for the first class's bytes
    (``compute``), unpacking the outputs (``fetch``) and on the host
    (``host``, 0: no image is encoded there); ``last_stats`` the early
    drains, OOM re-dispatches and images that did not fit
    (``oom_errors``)."""

    # --- one class ---------------------------------------------------------

    def _run(self, items, key, dev):
        """Stage and encode one class on ``dev``. Returns ((stream bytes,
        exact totals), device bytes of the input and packed pixels, None)."""
        colch, has_alpha, compat, n_pad = key
        stride = colch + int(has_alpha)
        pin = dev.type == "cuda"
        b = len(items)
        with trace.span("parallel.stage.fill"):
            buf = torch.empty((b, n_pad * stride), dtype=torch.uint8,
                              pin_memory=pin)
            nval = torch.empty(b, dtype=torch.int32, pin_memory=pin)
            buf_np, nval_np = buf.numpy(), nval.numpy()
            for j, (_, pix, desc) in enumerate(items):
                n = desc.n_pixels * stride
                buf_np[j, :n] = np.asarray(pix, np.uint8).reshape(-1)
                buf_np[j, n:] = 0
                nval_np[j] = desc.n_pixels
        with trace.span("parallel.stage.dispatch"):
            words = buf.to(dev, non_blocking=True).view(torch.int32)
            packed = words if stride == 4 else pack.pack_words(words, stride)
            # K2 is sized from the front's exact totals: reading them waits
            # for the front
            out, total = encode_v2.encode_stream_batched(
                packed, nval.to(dev, non_blocking=True), colch=colch,
                compat=compat)
        in_bytes = buf.numel() + (0 if stride == 4 else 4 * packed.numel())
        return (out, total), in_bytes, None

    @staticmethod
    def _finish(entry: _Pending, results) -> None:
        """Unpack one class's bytes into results."""
        with trace.span("parallel.wait", why="unpack", key=entry.key):
            if entry.done is not None:
                entry.done.synchronize()
        out, total = entry.host
        with trace.span("parallel.unpack.copy", key=entry.key,
                        bytes=out.numel()):
            out, total = out.numpy(), total.numpy()
            for j, (i, _, desc) in enumerate(entry.items):
                # header + body in one copy out of the pinned buffer
                results[i] = b"".join((spec.pack_header(desc),
                                       memoryview(out[j, : total[j]])))

    # --- the call ----------------------------------------------------------

    def __call__(self, images, descs):
        with trace.entry("api.batch_encode", images=len(images)) as call:
            return self._encode(images, descs, call)

    def _encode(self, images, descs, call):
        results: list[bytes | None] = [None] * len(images)
        groups = defaultdict(list)
        for i, (pix, desc) in enumerate(zip(images, descs)):
            if pix is None or desc is None or not spec.validate_encode_desc(
                    desc):
                continue
            # K4 packs whole groups of 4 pixels: the bucket is at least 4
            key = (desc.col_channels, desc.has_alpha, bool(desc.qoi_compat),
                   max(pixel_bucket(desc.n_pixels), 4))
            groups[key].append((i, pix, desc))
        call.set(classes=len(groups))

        stats = self._stats = {"early_drains": 0, "oom_redispatch": 0,
                               "oom_errors": 0}

        def finish(entry):
            self._finish(entry, results)

        queue, t_stage, t_early = self._queue(groups.items(), results, finish)
        t_compute, t_fetch = self._drain(queue, finish)
        self.last_timings = {"stage": t_stage, "compute": t_compute,
                             "fetch": t_fetch + t_early, "host": 0.0}
        self.last_stats = stats
        return results

    def _unfit(self, item, results):
        self._stats["oom_errors"] += 1


def corpus_encode(images, descs, device="cuda", mesh=None):
    return BatchEncoder(device, mesh=mesh)(images, descs)
