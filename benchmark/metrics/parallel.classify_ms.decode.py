"""Σ of the program's parallel.classify spans (each stream's header read and
the streams grouped into classes, before any class is staged) under
api.batch_decode, mean per call, in ms; from the program's tracer over the
traced window. None where no call of the window holds the span: a program
without it, as before it was added, leaves the metric out."""
from benchmark.harness.program_spans import span_ms, window_calls

SPAN = "parallel.classify"


def read(rec):
    calls = window_calls(rec, "api.batch_decode")
    if calls is None or not any(s["name"] == SPAN for c in calls
                                for s in c["spans"]):
        return None
    return span_ms(rec, "api.batch_decode", {SPAN})
