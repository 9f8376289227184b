"""``BatchDecoder`` over many small RGB SQOA streams on the CPU, as a training
loader of 32x32 images calls it: 32x32 photos with the generator's plateau
off (stream bucket 4096, 8 streams a packed row) and at its default (bucket
1024, 32 a row) make two icon classes on the packed route, and one 40x24
texture takes the regular route in a class of its own. The streams and
images come from the benchmark's reference (``benchmark/reference``:
``corpus.make_images``, ``codec.encode``, the plain ``codec.decode``).

Held: results in input order and byte-exact to the reference's decode and
to the source images; ``last_stats["packed_rows"]`` as the buckets give it;
one ``parallel.classify`` span a call with its ``images`` and ``classes``;
and the always-on counters ``parallel.packed.images`` / ``.rows`` moved by
the packed images and rows, with spans on or off."""

import numpy as np
import pytest
import torch

from benchmark.reference import codec, corpus
from seqoia_tpu_torch.parallel import batch
from seqoia_tpu_torch.utils import trace

torch.set_num_threads(1)

SPECS = [
    {"category": "flat", "generator": "photo", "count": 12, "width": 32,
     "height": 32, "args": {"plateau": 0.0}},
    {"category": "plateau", "generator": "photo", "count": 11, "width": 32,
     "height": 32},
    {"category": "odd", "generator": "texture", "count": 1, "width": 40,
     "height": 24},
]
N = sum(s["count"] for s in SPECS)
ROW_BYTES = 32768   # a packed row's bytes


@pytest.fixture(autouse=True)
def spans_off():
    trace.disable()
    yield
    trace.disable()


def _pow2(x):
    return 1 << (int(x) - 1).bit_length()


def _batch(seed, order):
    """(streams, images) of the mix, in the order ``order`` names."""
    images = [img for _, img in corpus.make_images(SPECS, seed, "cpu")]
    idx = np.arange(len(images))
    if order == "shuffled":
        idx = np.random.default_rng(seed).permutation(len(images))
    elif order == "reversed":
        idx = idx[::-1]
    images = [images[i] for i in idx]
    streams = [codec.encode(img, img.shape[1], img.shape[0], img.shape[2])
               .numpy().tobytes() for img in images]
    return streams, images


def _packed(streams, images):
    """{stream bucket: images} of the classes the packed route takes: two
    or more 32x32 streams of one bucket (at most 8192 bytes)."""
    classes = {}
    for s, img in zip(streams, images):
        if img.shape[:2] == (32, 32):
            classes.setdefault(_pow2(len(s)), []).append(s)
    return {b: len(v) for b, v in classes.items() if len(v) >= 2}


CASES = [(seed, order) for seed in (3, 2**31 + 19)
         for order in ("as_made", "shuffled", "reversed")]


@pytest.mark.parametrize("seed,order", CASES)
def test_results_in_order_and_byte_exact(seed, order):
    streams, images = _batch(seed, order)
    out = batch.BatchDecoder(device="cpu")(streams)
    assert len(out) == N
    for r, s, img in zip(out, streams, images):
        h, w, c = img.shape
        assert r.error is None
        assert (r.desc.width, r.desc.height, r.desc.channels) == (w, h, c)
        want, desc = codec.decode(s)
        assert desc == (w, h, c, 0, 0)
        assert bytes(np.asarray(r.pixels)) == bytes(want)
        assert np.array_equal(np.asarray(r.pixels), img.numpy().reshape(-1))


@pytest.mark.parametrize("seed,order", CASES)
def test_packed_rows_follow_the_buckets(seed, order):
    streams, images = _batch(seed, order)
    classes = _packed(streams, images)
    assert sorted(classes) == [1024, 4096]
    assert sum(classes.values()) == N - 1   # all but the 40x24 texture
    dec = batch.BatchDecoder(device="cpu")
    dec(streams)
    assert dec.last_stats["packed_rows"] == sum(
        -(-n // (ROW_BYTES // b)) for b, n in classes.items())
    assert dec.last_stats["host_rows"] == 0


@pytest.mark.parametrize("spans", ["on", "off"])
@pytest.mark.parametrize("seed", [3, 2**31 + 19])
def test_classify_span_and_packed_counters(seed, spans):
    streams, images = _batch(seed, "shuffled")
    classes = _packed(streams, images)
    rows = sum(-(-n // (ROW_BYTES // b)) for b, n in classes.items())
    dec = batch.BatchDecoder(device="cpu")
    last = trace.calls(1)
    before = trace.counters()
    if spans == "on":
        trace.enable()
    dec(streams)
    trace.disable()
    after = trace.counters()

    def moved(name):
        return after.get(name, 0) - before.get(name, 0)

    assert moved("parallel.packed.images") == N - 1
    assert moved("parallel.packed.rows") == rows == dec.last_stats[
        "packed_rows"]
    if spans == "off":
        assert trace.calls(1) == last
        return
    (call,) = trace.calls(1)
    assert call["counters"]["parallel.packed.images"] == N - 1
    assert call["counters"]["parallel.packed.rows"] == rows
    root = call["spans"][0]
    (span,) = [s for s in call["spans"] if s["name"] == "parallel.classify"]
    assert span["parent"] == root["id"]
    assert span["attrs"] == {"images": N, "classes": len(classes) + 1}
    assert root["attrs"] == span["attrs"]
    # the header read comes before every class is staged
    assert all(s["start_ns"] >= span["end_ns"] for s in call["spans"]
               if s["name"] == "parallel.class")
