"""Arithmetic the metric readers share: rates over the window, the roofline
share and the idle share. Each returns None where the run has
nothing to read, and the metric is then left out of the result line."""

from __future__ import annotations

from . import peaks


def per_window(rec, unit: str, scale: float = 1e-6):
    """Σ ``unit`` over every call of the window ÷ the window's seconds."""
    total = sum(c["units"].get(unit, 0) for c in rec.calls)
    if not total or rec.window_s <= 0:
        return None
    return total * scale / rec.window_s


def roofline_pct(rec, unit: str, byte_units=("stream_bytes",
                                              "pixel_bytes")):
    """Σ over the traced window's calls of their problem bytes (each input
    byte read once, each output byte written once) ÷ the HBM peak, as a
    share of Σ kernel time over the cards."""
    if rec.trace is None:
        return None
    calls = [c for c in rec.calls if c["units"].get(unit)]
    nbytes = sum(c["units"][b] for c in calls for b in byte_units)
    kernel_s = sum(rec.trace["kernel_s"])
    if not nbytes or kernel_s <= 0:
        return None
    return 100.0 * peaks.byte_bound_s(nbytes) / kernel_s


def idle_pct(rec, unit: str):
    """1 − busy ÷ window, averaged over the cards, of a traced window whose
    calls did ``unit`` work."""
    if rec.trace is None or not any(c["units"].get(unit) for c in rec.calls):
        return None
    win = rec.trace["window_s"]
    busy = rec.trace["busy_s"]
    return 100.0 * sum(1 - b / win for b in busy) / len(busy)


def counter_mean(rec, read):
    """The mean over calls of ``read(call)``, the calls where it is None
    left out."""
    vals = [v for v in (read(c) for c in rec.calls) if v is not None]
    return sum(vals) / len(vals) if vals else None
