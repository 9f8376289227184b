"""The .qoi fixpoint's resolutions plus its restart's, summed over a call's
classes, mean per call; from decode_compat's stats= dict, which a traced
run's span around decode_stream_compat_batched hands it."""
from benchmark.harness.readings import counter_mean


def _passes(call):
    c = call["counters"].get("compat")
    if not c:
        return None
    return sum(s["passes"] + s["settle_passes"] for s in c)


def read(rec):
    return counter_mean(rec, _passes)
