"""The tracer's record (``seqoia_tpu_torch.utils.trace``) at its real size:
it keeps the last ``RING`` root calls, consecutive and whole, and drops the
one before them; a root's children stay in its call and take no place of
their own."""

import pytest

from seqoia_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    yield
    trace.disable()
    trace._record.clear()  # the tests' calls, not another file's


def _roots(n, name="test.ring"):
    """``n`` root calls of ``name``, each with one child; the ids of the
    first and the last."""
    trace.enable()
    try:
        for i in range(n):
            with trace.entry(name, i=i) as root:
                with trace.span("test.ring.child"):
                    pass
            if i == 0:
                first = root.call.id
    finally:
        trace.disable()
    return first, root.call.id


def test_the_record_is_the_ring():
    assert trace._record.maxlen == trace.RING == 32768


@pytest.mark.parametrize("extra", [0, 1])
def test_record_keeps_the_last_ring_calls(extra):
    """RING calls are all kept; one more drops the first of them, and
    only it."""
    first, last = _roots(trace.RING + extra)
    calls = trace.calls()
    assert len(calls) == trace.RING
    ids = [c["id"] for c in calls]
    assert ids == list(range(first + extra, last + 1))
    assert calls[-1]["id"] == last
    kept = [c["spans"][0]["attrs"]["i"] for c in (calls[0], calls[-1])]
    assert kept == [extra, trace.RING + extra - 1]
    seqs = [c["seq"] for c in calls]
    assert seqs == list(range(seqs[0], seqs[0] + trace.RING))
    assert seqs[-1] == trace.counters()["test.ring"]
    assert all([s["name"] for s in c["spans"]] ==
               ["test.ring", "test.ring.child"] for c in calls)
