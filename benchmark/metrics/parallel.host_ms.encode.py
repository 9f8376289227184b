"""The host time of an encode_large call spent neither inside
encode_v2.encode_stream_flat (the encode's kernels and its one read of the
exact total) nor in transfer.fetch_flat (the copy down and its
synchronise), mean per call, in ms; from the benchmark's spans of a traced
run."""
from benchmark.harness.readings import counter_mean


def _host_ms(call):
    s = call["spans"]
    if not call["units"].get("encoded_px") or "codec.encode_stream_flat" \
            not in s:
        return None
    return 1e3 * (call["wall_s"] - s["codec.encode_stream_flat"]
                  - s.get("parallel.fetch_flat", 0.0))


def read(rec):
    return counter_mean(rec, _host_ms)
