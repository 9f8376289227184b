"""Σ of the program's parallel.file_bytes spans (header and stream body
copied into one bytes object) under api.encode_large, mean per call, in
ms; from the program's tracer over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.encode_large", {"parallel.file_bytes"})
