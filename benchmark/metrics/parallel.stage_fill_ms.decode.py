"""Σ of the program's parallel.stage.fill spans (the pinned staging buffer
and the copies of the streams into it) under api.batch_decode, mean per
call, in ms; from the program's tracer over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.batch_decode", {"parallel.stage.fill"})
