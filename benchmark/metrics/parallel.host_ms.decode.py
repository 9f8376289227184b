"""stage + fetch + host of BatchDecoder.last_timings (the program's own
host spans), mean per call, in ms."""
from benchmark.harness.readings import counter_mean


def _host_ms(call):
    t = call["counters"].get("timings")
    if not t or not call["units"].get("decoded_px"):
        return None
    return 1e3 * (t["stage"] + t["fetch"] + t["host"])


def read(rec):
    return counter_mean(rec, _host_ms)
