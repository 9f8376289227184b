"""Σ of the program's parallel.wait spans (the host blocked on the card:
the exact-total read, the stream's length, the copy down's synchronize)
under api.encode_large, mean per call, in ms; from the program's tracer
over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.encode_large", {"parallel.wait"})
