"""``harness/trace.summarize`` on a made-up profile: busy time as the
union of device intervals inside the window, kernel time, and idle time
split over the innermost host span."""

import pytest
import torch

from benchmark.harness import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class _Event:
    def __init__(self, name, start, end, dev=CPU, index=0, kind=None):
        self._n, self._s, self._e = name, start, end
        self._d, self._i, self._k = dev, index, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def device_index(self):
        return self._i


class _Named(_Event):
    def activity_type(self):
        return self._k


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def _events(cls):
    ms = 1_000_000
    return [
        cls("bench/window", 0, 100 * ms, kind="user_annotation"),
        cls("bench/call", 0, 90 * ms, kind="user_annotation"),
        cls("bench/parallel.stage_class", 10 * ms, 30 * ms,
            kind="user_annotation"),
        cls("k1", 20 * ms, 40 * ms, CUDA, 0, "kernel"),
        cls("k2", 35 * ms, 50 * ms, CUDA, 0, "kernel"),
        cls("Memcpy HtoD (Pinned -> Device)", 60 * ms, 70 * ms, CUDA, 0,
            "gpu_memcpy"),
        cls("k1", 95 * ms, 120 * ms, CUDA, 0, "kernel"),  # cut at the end
        cls("aten::add", 0, 1 * ms, kind="cpu_op"),
    ]


@pytest.mark.parametrize("cls", [_Event, _Named])
def test_summarize(cls):
    s = trace.summarize(_Prof(_events(cls)), 1)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == [pytest.approx(0.045)]      # 20-50, 60-70, 95-100
    assert s["kernel_s"] == [pytest.approx(0.040)]    # 20, 15, 5
    assert dict((n, v) for n, v in s["device_ops"]) == pytest.approx(
        {"k1": 0.025, "k2": 0.015, "Memcpy HtoD (Pinned -> Device)": 0.010})
    # idle 0-20 (call 0-10, stage 10-20), 50-60, 70-90 (call), 90-95
    assert dict((n, v) for n, v in s["idle_gaps"]) == pytest.approx(
        {"call": 0.040, "parallel.stage_class": 0.010, "outside": 0.005})


def test_no_window_no_summary():
    assert trace.summarize(_Prof(_events(_Named)[1:]), 1) is None
