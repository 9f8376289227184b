"""Σ of the program's codec.fixpoint.pass, codec.settle.pass and
codec.sequential spans (the .qoi fixpoint's and its restart's passes, each
ending in a host read, and K9's rows) under api.batch_decode, mean per
call, in ms; from the program's tracer over the traced window."""
from benchmark.harness.program_spans import span_ms


def read(rec):
    return span_ms(rec, "api.batch_decode", {
        "codec.fixpoint.pass", "codec.settle.pass", "codec.sequential"})
