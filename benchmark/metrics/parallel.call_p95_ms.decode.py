"""The 95th percentile of the wall time of every decode call in the traced
window (host clock), in ms: the nearest rank, so the value is a call's own
time. The loader's slowest steps; per layer, since the host's drift moves
it by more than any bound the check allows (PERF.md §2)."""
import math


def read(rec):
    walls = sorted(c["wall_s"] for c in rec.calls
                   if c["units"].get("decoded_px"))
    if not walls:
        return None
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
