"""Decoded pixels of every call in the window ÷ the window (host clock)."""
from benchmark.harness.readings import per_window


def read(rec):
    return per_window(rec, "decoded_px")
