"""Encoded pixels of every call in the traced window ÷ the window (host
clock). The archive writer's rate; per layer, since the host's drift moves
it by more than any bound the check allows (PERF.md §2)."""
from benchmark.harness.readings import per_window


def read(rec):
    return per_window(rec, "encoded_px")
