"""The program's parallel.packed.images counter (the images of each class
decoded as segment-packed rows: K1 in segment mode, K2 over the rows), its
delta over each BatchDecoder call, mean per call; from the program's tracer
over the traced window. None where no call of the window counted it: a
program without the counter, as before it was added, leaves the metric
out."""
from benchmark.harness.program_spans import counter_per_call, window_calls

COUNTER = "parallel.packed.images"


def read(rec):
    calls = window_calls(rec, "api.batch_decode")
    if calls is None or not any(COUNTER in c["counters"] for c in calls):
        return None
    return counter_per_call(rec, "api.batch_decode", COUNTER)
