"""Σ of the program's parallel.stage.fill (the pinned buffer, the copy of
the pixels, the zeroed tail) and parallel.stage.dispatch (the copy up and
K4's enqueue) spans under api.encode_large, mean per call, in ms; from the
program's tracer over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.encode_large",
                   {"parallel.stage.fill", "parallel.stage.dispatch"})
