"""The program's own spans and counters over a traced window, as its tracer
(``seqoia_tpu_torch.utils.trace``) recorded them, for the metric readers
whose ``source`` is ``program_span`` or ``program_counter``.

The window's calls are the tracer's last ``len(rec.calls)`` root calls. They
are taken only when each is a call of the entry point the reader names
(``root``), their ids are consecutive (none dropped from the tracer's
record), their ``seq`` runs without a gap to the entry point's call count
now (every call of it since the window began was recorded, none after it),
and none lasted longer than the window's call it stands for. Otherwise, as
where spans were off (a traced run on the CPU starts no profiler) or the
program has no tracer (an older checkout), each reader returns None.
"""

from __future__ import annotations


def window_calls(rec, root: str):
    """The window's root calls (``trace.calls()`` dicts), or None."""
    try:
        from seqoia_tpu_torch.utils import trace
    except ImportError:
        return None
    n = len(rec.calls)
    if n == 0:
        return None
    calls = trace.calls(n)
    if len(calls) < n or any(c["name"] != root for c in calls):
        return None
    first_id, first_seq = calls[0]["id"], calls[0]["seq"]
    if [c["id"] for c in calls] != list(range(first_id, first_id + n)) or \
            [c["seq"] for c in calls] != list(range(first_seq,
                                                    first_seq + n)):
        return None
    if calls[-1]["seq"] != trace.counters().get(root, 0):
        return None
    if any((c["end_ns"] - c["start_ns"]) / 1e9 > r["wall_s"]
           for c, r in zip(calls, rec.calls)):
        return None
    return calls


def span_ms(rec, root: str, names, own: bool = False):
    """Σ over the window's calls of the durations (``own``: self times) of
    the spans named ``names``, in ms, mean per call."""
    calls = window_calls(rec, root)
    if calls is None:
        return None
    key = "self_ns" if own else None
    total = sum(s[key] if key else s["end_ns"] - s["start_ns"]
                for c in calls for s in c["spans"] if s["name"] in names)
    return total / 1e6 / len(calls)


def counter_per_call(rec, root: str, name: str):
    """Σ over the window's calls of counter ``name``'s deltas, mean per
    call."""
    calls = window_calls(rec, root)
    if calls is None:
        return None
    return sum(c["counters"].get(name, 0) for c in calls) / len(calls)
