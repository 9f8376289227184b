"""Σ of the program's parallel.wait spans (the host blocked on a card
event: the first class's and each class's copy down) under
api.batch_decode, mean per call, in ms; from the program's tracer over the
traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.batch_decode", {"parallel.wait"})
