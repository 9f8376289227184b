"""Spans around the program's layers, and the device trace of a window.

``Spans`` wraps functions of the program for a traced run: each call is
timed by the host clock (summed per name into ``current``, which the run
hands to each call's record) and opened as a ``torch.profiler``
annotation ``bench/<name>``, so the device trace can say which span was
open while the card sat idle. Untraced runs wrap nothing.

``summarize`` reads a finished profile: per card, the union of the
intervals in which a kernel, a copy or a memset ran (``busy_s``) and the
kernels' summed time (``kernel_s``), within the ``bench/window``
annotation; the device operations by summed time; and every idle stretch
of a card split over the innermost ``bench/`` span open on the host at the
time (``outside`` where none was).
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict

import torch

WINDOW = "bench/window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e) -> str | None:
    """``user_annotation`` (a host span), a device kind of _DEVICE_KINDS, or
    None. PyTorch builds that do not name an event's activity get it from
    the device and the names CUPTI gives copies and memsets."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if name.startswith("bench/") else None
    if name.startswith("bench/") or getattr(e, "is_user_annotation",
                                            lambda: False)():
        return None
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Spans:
    """Wrap ``(owner, attribute, span name)`` targets while active."""

    def __init__(self, targets):
        self.targets = list(targets)
        self.current: dict = defaultdict(float)
        self._saved: list = []

    def _wrap(self, fn, name):
        current = self.current

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench/" + name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    current[name] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        for owner, attr, name in self.targets:
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(
                owner, attr)
            self._saved.append((owner, attr, fn))
            if isinstance(fn, staticmethod):
                setattr(owner, attr, staticmethod(self._wrap(fn.__func__,
                                                             name)))
            else:
                setattr(owner, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def take(self) -> dict:
        """The seconds per span since the last take."""
        out = dict(self.current)
        self.current.clear()
        return out


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(spans, lo, hi):
    """[(start, end, name)] segments of [lo, hi) labelled by the innermost
    open span (the one opened last), ``outside`` where none is open."""
    edges = []
    for s, e, name in spans:
        edges.append((s, 1, name))
        edges.append((e, 0, name))
    edges.sort()
    out, stack, t = [], [], lo
    for at, opening, name in edges:
        at = min(max(at, lo), hi)
        if at > t:
            out.append((t, at, stack[-1] if stack else "outside"))
            t = at
        if opening:
            stack.append(name)
        elif name in stack:  # the latest opened of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if hi > t:
        out.append((t, hi, stack[-1] if stack else "outside"))
    return out


def summarize(prof, n_cards: int) -> dict | None:
    """The window's device readings (module docstring), or None when the
    profile holds no window or no device activity."""
    win, spans = None, []
    dev = defaultdict(list)        # card -> [(start, end)]
    kern = defaultdict(float)      # card -> kernel seconds
    ops = defaultdict(float)       # name -> seconds, all cards
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind == "user_annotation":
            name = e.name()
            if name == WINDOW:
                win = (e.start_ns(), e.end_ns())
            elif name.startswith("bench/"):
                spans.append((e.start_ns(), e.end_ns(), name[6:]))
        elif kind in _DEVICE_KINDS:
            dev[e.device_index()].append((e.start_ns(), e.end_ns(), kind,
                                          e.name()))
    if win is None or not dev:
        return None
    lo, hi = win
    busy, gaps_by_span = [], defaultdict(float)
    segments = _innermost(spans, lo, hi)
    for card in range(n_cards):
        ivs = []
        for s, e, kind, name in dev.get(card, ()):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            ivs.append((s, e))
            ops[name] += (e - s) / 1e9
            if kind == "kernel":
                kern[card] += (e - s) / 1e9
        merged = _union(ivs)
        busy.append(sum(e - s for s, e in merged) / 1e9)
        # idle stretches of this card, split over the host's spans
        idle, t = [], lo
        for s, e in merged:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if hi > t:
            idle.append((t, hi))
        j = 0
        for s, e in idle:
            while j < len(segments) and segments[j][1] <= s:
                j += 1
            k = j
            while k < len(segments) and segments[k][0] < e:
                a, b, name = segments[k]
                gaps_by_span[name] += (min(b, e) - max(a, s)) / 1e9 / n_cards
                k += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gaps_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy,
            "kernel_s": [kern[c] for c in range(n_cards)],
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
