"""Spans and counters inside ``seqoia_tpu_torch``: where a call's time goes.

``span(name, **attrs)`` is a context manager around one step of a call (a
class dispatched, a wait on the card, a fixpoint pass). It is on while an
operator has called ``enable()`` or while a ``torch.profiler`` session
records; otherwise it returns one shared no-op object after a single check,
and records and emits nothing. On, it does two things:

* while the profiler records, it opens ``torch.profiler.record_function(
  "seqoia/" + name)``: the span lands on the profiler's clock, the one the
  card's kernels and copies are stamped with, so an idle stretch of the
  card in any profile of the program falls under the span the host was in;
* it adds the span to an in-memory record: name, start and end
  (``time.perf_counter_ns``), the id of the span that opened it, the id of
  the root call it belongs to, and its attributes (``set()`` adds more,
  also after the span closed, until its root closes).

A span opened on a thread with no span open is a root call. The public
entry points open theirs with ``entry(name)`` (or the decorator
``entry_point(name)``), which also counts the call under its name whether
spans are on or not; one called inside another is a child of the outer
call, not a root of its own. Spans nest per thread.

``count(name, n=1)`` adds to a process-wide counter table (``counters()``),
always: one dict add under a lock, no timing. A root call recorded while
spans are on keeps the deltas of the counters over it. The program counts
``kernels.launches.<id>`` (one a kernel launch; ``K1`` every K1 launch,
``K1.seg`` those in segment mode and ``K1.mono`` those in mono mode, ``K2``
every K2 launch and ``K2.conv`` those with a channel-converting epilogue,
``K9`` the color step and ``K9.mono`` the mono step), ``codec.host_syncs``
(one a host read of a device value by the codec, with a count per kind
under ``codec.host_syncs.<kind>``), ``codec.emit.rows`` (one a row whose
pixels K2 emits with a channel conversion, a gray source at 3/4 channels or
a colour one at 1/2, and every ``.qoi`` row; the launch runs in the span
``codec.emit_pixels`` with ``rows``, ``colch``, ``out_ch`` and ``n_max``)
and ``parallel.mono.images`` (one an image of a ``BatchDecoder`` class with
a gray source dispatched to the device).

``calls(n=None)`` returns the last ``n`` finished root calls, oldest
first: each with its id (root calls take consecutive ids, so a gap shows
calls dropped), its ``seq`` (its entry's call count when it began: the
calls of one entry point recorded without a gap have consecutive ``seq``),
its counter deltas and its spans in the order they opened, each with its
self time (its duration less its children's). The record keeps the last
``RING`` root calls.

For an operator: a timeline comes from any ``torch.profiler`` trace of the
program (the ``seqoia/`` ranges beside the device activity); numbers come
from ``trace.enable()``, the calls, then ``trace.calls()``. There is no
exporter of its own, no environment variable and no setting.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch

#: root calls the record keeps. A traced 40 s window of the benchmark made
#: 1863-2243 calls of 24 Kodak-sized photos on an H100, and 3816-3975 of 512
#: CIFAR-10-sized images (an untraced one up to 8330 on a faster host); the
#: record holds the traced window of a call four times as fast
RING = 32768
PREFIX = "seqoia/"

_enabled = False
_profiling = torch.autograd._profiler_enabled
_record_function = torch.profiler.record_function
_counts: dict = {}
_counts_lock = threading.Lock()
_record: collections.deque = collections.deque(maxlen=RING)
_span_ids = itertools.count()
_call_ids = itertools.count()
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn spans on for every thread (``enable(False)``: off again; a
    profiler session still turns them on while it records)."""
    global _enabled
    _enabled = bool(on)


def disable() -> None:
    enable(False)


def is_on() -> bool:
    """Whether spans record now."""
    return _enabled or _profiling()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of the counter table."""
    with _counts_lock:
        return dict(_counts)


def host_sync(kind: str) -> None:
    """Count one host read of a device value by the codec: under
    ``codec.host_syncs`` and ``codec.host_syncs.<kind>``."""
    with _counts_lock:
        for name in ("codec.host_syncs", "codec.host_syncs." + kind):
            _counts[name] = _counts.get(name, 0) + 1


class _Off:
    """The span while spans are off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager timing one step (module docstring)."""
    if _enabled or _profiling():
        return _Span(name, attrs)
    return _OFF


def entry(name: str, **attrs):
    """The span of a public entry point: counts the call under ``name``,
    spans on or off, then opens ``span(name, **attrs)``."""
    count(name)
    return span(name, **attrs)


def entry_point(name: str):
    """Decorator: each call of the function runs inside ``entry(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with entry(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Call:
    """One root call while it runs and once it is recorded."""

    __slots__ = ("id", "name", "seq", "start_ns", "end_ns", "spans",
                 "counters")

    def __init__(self, name):
        self.id = next(_call_ids)
        self.name = name
        with _counts_lock:
            self.seq = _counts.get(name, 0)
            self.counters = dict(_counts)  # the deltas once it closes
        self.spans: list = []

    def close(self, start_ns, end_ns):
        self.start_ns, self.end_ns = start_ns, end_ns
        before = self.counters
        with _counts_lock:
            self.counters = {k: v - before.get(k, 0)
                             for k, v in _counts.items()
                             if v != before.get(k, 0)}
        _record.append(self)

    def as_dict(self) -> dict:
        spans = sorted(self.spans, key=lambda s: s[0])
        return {"id": self.id, "name": self.name, "seq": self.seq,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "counters": dict(self.counters),
                "spans": [{"id": i, "parent": p, "call": self.id,
                           "name": n, "start_ns": s, "end_ns": e,
                           "self_ns": own, "attrs": dict(a)}
                          for i, p, n, s, e, own, a in spans]}


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start", "child",
                 "_rf")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = _stack()
        self._rf = None
        if _profiling():
            self._rf = _record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.id = next(_span_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, _Call(self.name)
        self.child = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        dur = end - self.start
        self.call.spans.append((self.id, self.parent, self.name, self.start,
                                end, dur - self.child, self.attrs))
        if stack:
            stack[-1].child += dur
        else:
            self.call.close(self.start, end)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def calls(n: int | None = None) -> list:
    """The last ``n`` (default: every recorded) finished root calls, oldest
    first, as dicts (module docstring)."""
    done = list(_record)
    if n is not None:
        done = done[-n:] if n > 0 else []
    return [c.as_dict() for c in done]
