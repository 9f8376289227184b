"""Σ (stream bytes read once + pixel bytes written once) of the decoded
images ÷ 3.35 TB/s, as a share of Σ kernel time on the cards in the traced
window (torch.profiler)."""
from benchmark.harness.readings import roofline_pct


def read(rec):
    return roofline_pct(rec, "decoded_px")
