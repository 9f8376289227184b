"""The program's parallel.unpack.reuse counter (one a class whose results
went into a host array the decoder reused rather than a new one), its
delta over each BatchDecoder call, mean per call; from the program's
tracer over the traced window. A program without the counter reads 0."""
from benchmark.harness.program_spans import counter_per_call


def read(rec):
    return counter_per_call(rec, "api.batch_decode", "parallel.unpack.reuse")
