"""The program's codec.host_syncs counter (one a host read of a device
value by the codec), its delta over each BatchDecoder call, mean per call;
from the program's tracer over the traced window."""
from benchmark.harness.program_spans import counter_per_call


def read(rec):
    return counter_per_call(rec, "api.batch_decode", "codec.host_syncs")
