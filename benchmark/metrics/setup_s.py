"""Seconds from the start of run.py to the first timed call (host clock)."""


def read(rec):
    return rec.setup_s
