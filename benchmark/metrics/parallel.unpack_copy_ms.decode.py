"""Σ self time of the program's parallel.unpack.copy spans (a class's output
copied out of pinned memory, its results made), mean per BatchDecoder call,
in ms; from the program's tracer over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.batch_decode", {"parallel.unpack.copy"},
                   own=True)
