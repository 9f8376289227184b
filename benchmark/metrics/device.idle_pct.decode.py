"""1 − (union of kernel, copy and memset intervals) ÷ the traced window,
averaged over the cards, of a decode window (torch.profiler)."""
from benchmark.harness.readings import idle_pct


def read(rec):
    return idle_pct(rec, "decoded_px")
