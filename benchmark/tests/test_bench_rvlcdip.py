"""The cell ``rvlcdip.sqoa_decode_rgb`` on the CPU with its pages scaled down
to 100 px on the long side, six in place of 128, in the configuration's
three aspects: every page is a gray SQOA stream asked for at 3 channels, so
K1 runs in mono mode and ``_emit_pixels`` replicates the gray. A sound run
is correct; the control is not, nor are two planted faults (the pages
returned gray at 1 channel, one byte of one replicated channel altered);
the entry's expected output is the reference decoder's at every channel
count; the cell's two readers read the program's ``parallel.mono.images``
and ``codec.emit.rows`` counters from a traced record, and None where the
record lacks them or the program has no tracer."""

import copy
import functools

import numpy as np
import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness import runner

CELL = "rvlcdip.sqoa_decode_rgb"
ROOT = "api.batch_decode"
# the committed pages (count, width, height) and the ones run here
PAGES = {"letter": ((96, 773, 1000), (3, 77, 100)),
         "a4": ((24, 707, 1000), (2, 71, 100)),
         "landscape": ((8, 1000, 773), (1, 100, 77))}
N = sum(small[0] for _, small in PAGES.values())
METRICS = {"parallel.mono_images.decode": "parallel.mono.images",
           "codec.emit_rows.decode": "codec.emit.rows"}


def _config():
    """The committed configuration with the pages of ``PAGES``' right
    column."""
    _, cfg, _ = mf.load_cell(mf.load_manifest(), CELL)
    cfg = copy.deepcopy(cfg)
    assert [im["category"] for im in cfg["images"]] == list(PAGES)
    for im in cfg["images"]:
        committed, small = PAGES[im["category"]]
        assert im["generator"] == "mono_doc"
        assert (im["count"], im["width"], im["height"]) == committed
        im["count"], im["width"], im["height"] = small
    return cfg


def _run(trace=False, control=False, seed=2**31 + 2626):
    return runner.run(CELL, seed, 0.2, trace,
                      devices=[torch.device("cpu")], config=_config(),
                      control=control)


def _entry_module():
    return mf.load_module("entries", "batch_decode_channels")


def test_cell_is_in_the_manifest():
    man = mf.load_manifest()
    _, cfg, traffic = mf.load_cell(man, CELL)
    assert cfg["reduced"] == [] and traffic["channels"] == 3
    assert sum(im["count"] for im in cfg["images"]) == 128
    traced = {m["name"] for m in mf.cell_metrics(man, CELL, True)}
    assert set(METRICS) <= traced
    assert {m["name"] for m in mf.cell_metrics(man, CELL, False)} == {
        "decode_mpx_s", "device_peak_gib", "setup_s"}


def test_sound_run_is_correct(monkeypatch):
    from seqoia_tpu_torch.parallel import batch

    seen = []
    fn = batch.BatchDecoder.__call__

    @functools.wraps(fn)
    def call(self, streams, channels=0):
        out = fn(self, streams, channels)
        seen.append((channels, dict(self.last_stats),
                     [r.pixels.size for r in out]))
        return out

    monkeypatch.setattr(batch.BatchDecoder, "__call__", call)
    res, compared = _run()
    assert res["correct"], compared
    assert res["attempted"] == N * res["calls"] and res["failed"] == 0
    assert all(v == 0 for _, v, _ in compared)
    sizes = [3 * w * h for _, (c, w, h) in PAGES.values() for _ in range(c)]
    assert seen and all(
        ch == 3 and s["packed_rows"] == 0 and s["host_rows"] == 0
        and got == sizes for ch, s, got in seen)


def test_control_is_not_correct():
    res, compared = _run(control=True)
    assert not res["correct"]
    assert max(v for _, v, lim in compared if v > lim) > 100


@pytest.mark.parametrize("fault", ["gray_at_one_channel", "replica_byte"])
def test_planted_fault_is_caught(monkeypatch, fault):
    from seqoia_tpu_torch.parallel import batch

    if fault == "gray_at_one_channel":
        fn = batch.BatchDecoder.__call__

        @functools.wraps(fn)
        def call(self, streams, channels=0):
            return fn(self, streams, 1)

        monkeypatch.setattr(batch.BatchDecoder, "__call__", call)
    else:
        fn = batch.BatchDecoder._finish

        @functools.wraps(fn)
        def finish(self, entry, results, fallback):
            fn(self, entry, results, fallback)
            px = results[entry.items[-1][0]].pixels
            px[3 * (px.size // 6) + 2] ^= 0x10  # a pixel's B, its gray's copy

        monkeypatch.setattr(batch.BatchDecoder, "_finish", finish)
    res, compared = _run()
    assert not res["correct"]
    assert dict((n, v) for n, v, _ in compared)["wrong_pixel_bytes"] > 0


def _image(c, seed=5):
    """A 12x10 image of ``c`` channels with runs, small steps and jumps."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randint(0, 256, (1, 1, c), generator=g)
    step = torch.randint(-3, 4, (10, 12, c), generator=g).cumsum(dim=1)
    jump = torch.randint(0, 256, (10, 12, c), generator=g)
    img = torch.where(torch.rand(10, 12, 1, generator=g) < 0.1, jump,
                      base + step)
    return (img & 255).to(torch.uint8)


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_expected_is_the_reference_decode(c, channels):
    from benchmark.reference import codec

    img = _image(c)
    data = codec.encode(img, 12, 10, c).numpy().tobytes()
    want, desc = codec.decode(data, channels)
    src = img.reshape(-1).numpy()
    assert desc[2] == c
    assert _entry_module().expected_at(src, c, channels).tobytes() == bytes(
        want)


def test_reference_decode_at_3_is_the_gray_replicated():
    from benchmark.reference import codec, corpus

    spec = dict(_config()["images"][0], count=1)
    ((_, page),) = corpus.make_images([spec], 11, "cpu")
    h, w, _ = page.shape
    data = codec.encode(page, w, h, 1).numpy().tobytes()
    gray = page.reshape(-1).numpy()
    want, desc = codec.decode(data, 3)
    assert desc[:3] == (w, h, 1)
    assert bytes(want) == np.repeat(gray, 3).tobytes()


@pytest.fixture(scope="module")
def traced():
    """The result line of one traced run with the program's tracer on, and
    its window's root calls."""
    from seqoia_tpu_torch.utils import trace

    trace.enable()
    try:
        res, _ = _run(trace=True)
        calls = trace.calls(res["calls"])
    finally:
        trace.disable()
    return res, calls


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_reads_a_traced_run(traced, metric):
    res, calls = traced
    assert res["correct"]
    assert res["metrics"][metric]["value"] == N
    assert all(c["name"] == ROOT and c["counters"][METRICS[metric]] == N
               for c in calls)
    for c in calls:
        (span,) = [s for s in c["spans"] if s["name"] == "codec.emit_pixels"]
        assert span["attrs"] == {"rows": N, "colch": 1, "out_ch": 3,
                                 "n_max": 8192}


def test_traced_run_reports_the_call_tail(traced):
    """The cell's slowest loader steps: the 95th percentile of the traced
    window's calls, one of their own times."""
    res, _ = traced
    p95 = res["metrics"]["parallel.call_p95_ms.decode"]
    assert p95["unit"] == "ms"
    assert res["call_ms"]["median"] <= p95["value"] <= res["call_ms"]["max"]


def _window_of_last(n):
    rec = runner.Record()
    rec.calls = [{"wall_s": 1e3}] * n
    return rec


def _one_call(channels, c=1):
    """One BatchDecoder call of a 12x10 image of ``c`` channels."""
    from benchmark.reference import codec
    from seqoia_tpu_torch.parallel import batch

    data = codec.encode(_image(c), 12, 10, c).numpy().tobytes()
    batch.BatchDecoder(device="cpu")([data], channels)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_is_none_without_its_counter(metric):
    """A root call that counts neither (as the program did before they were
    added), and a colour call that K2 emits: None; a gray page at 3
    channels: one."""
    from seqoia_tpu_torch.utils import trace

    reader = mf.load_module("metrics", metric)
    trace.enable()
    try:
        with trace.entry(ROOT):
            pass
        assert reader.read(_window_of_last(1)) is None
        _one_call(0, c=3)
        assert reader.read(_window_of_last(1)) is None
        _one_call(3)
    finally:
        trace.disable()
    assert reader.read(_window_of_last(1)) == 1


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_is_none_without_the_programs_tracer(metric, monkeypatch):
    import sys

    import seqoia_tpu_torch.utils as utils
    from seqoia_tpu_torch.utils import trace

    trace.enable()
    try:
        _one_call(3)
    finally:
        trace.disable()
    rec = _window_of_last(1)
    assert mf.load_module("metrics", metric).read(rec) is not None
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "seqoia_tpu_torch.utils.trace", None)
    assert mf.load_module("metrics", metric).read(rec) is None
