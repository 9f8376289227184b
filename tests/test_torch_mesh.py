"""The port's device mesh (``seqoia_tpu_torch.parallel.mesh``) and the
device guard of its kernel launches, on the CPU.

A mesh of ``(cpu,) * k`` splits every batch class and every large image
the way a mesh of k cards does, on the kernels' plain versions. The
outputs must not depend on k: ``BatchDecoder``, ``BatchEncoder``,
``encode_large``, ``decode_large`` and both shard forms at k = 1, 2, 4, 8
against the same call without a mesh, the JAX package on conftest's
8-device virtual CPU mesh (as tests/test_batch.py and
tests/test_sharding.py run it) and the native codec. Images are made from
a seed with numpy; streams and pixels are compared exactly (tolerance 0).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from conftest import gen_pixels
from seqoia_tpu import native
from seqoia_tpu.parallel import batch as jbatch
from seqoia_tpu.parallel import tiled as jtiled
from seqoia_tpu.parallel.mesh import default_mesh as jax_mesh
from seqoia_tpu_torch.ops import _build
from seqoia_tpu_torch.parallel import batch, batch_sharding, default_mesh
from test_torch_batch import _enc_list, _mixed, _native_enc, _same
from test_torch_tiled import _striped

# one thread per process: the suite runs several workers, and the plain
# versions' many small tensor ops only contend when each takes every core
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPU = torch.device("cpu")
_KS = (1, 2, 4, 8)


def _cpu_mesh(k):
    return default_mesh([_CPU] * k)


# --- the mesh ---------------------------------------------------------------

def test_default_mesh_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_default_mesh_of_given_devices():
    assert default_mesh(["cpu", _CPU]) == (_CPU, _CPU)
    with pytest.raises(ValueError):
        default_mesh([])
    with pytest.raises(ValueError):
        default_mesh(["meta"])


@pytest.mark.parametrize("k,n,want", [
    (1, 5, [(0, 5)]), (4, 10, [(0, 3), (3, 6), (6, 8), (8, 10)]),
    (4, 2, [(0, 1), (1, 2)]), (8, 0, []), (3, 3, [(0, 1), (1, 2), (2, 3)])])
def test_batch_sharding_splits_rows_into_contiguous_ranges(k, n, want):
    mesh = tuple(torch.device("cuda", i) for i in range(k))
    got = batch_sharding(mesh, n)
    assert [(lo, hi) for _, lo, hi in got] == want
    assert [d.index for d, _, _ in got] == list(range(len(want)))


def test_the_exports():
    from seqoia_tpu_torch import parallel

    for name in ("default_mesh", "batch_sharding"):
        assert name in parallel.__all__


# --- the device guard -------------------------------------------------------

def test_launch_makes_the_tensors_device_current(monkeypatch):
    """_build.launch passes the device's current stream last and enters the
    device only when it is not the current one; an error code raises."""
    entered, calls = [], []

    class Guard:
        def __init__(self, idx):
            self.idx = idx

        def __enter__(self):
            entered.append(self.idx)

        def __exit__(self, *exc):
            entered.append(-1)

    class Lib:
        rc = 0

        def k(self, *args):
            calls.append(args)
            return self.rc

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ("stream", dev))
    lib = Lib()
    _build.launch(lib, "k", torch.device("cuda", 0), 1, 2)
    assert entered == [] and calls == [(1, 2, ("stream", torch.device(
        "cuda", 0)))]
    _build.launch(lib, "k", torch.device("cuda", 1), 3)
    assert entered == [1, -1]
    assert calls[-1] == (3, ("stream", torch.device("cuda", 1)))
    lib.rc = 700
    with pytest.raises(RuntimeError, match="k failed: cudaError 700"):
        _build.launch(lib, "k", torch.device("cuda", 0))


def _python_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for sub in ("seqoia_tpu_torch", "tools"):
        for d, _, names in os.walk(os.path.join(_ROOT, sub)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(f for f in files if not f.endswith("_build.py"))


def test_every_kernel_call_goes_through_the_guard():
    """No port file but ops/_build.py reads a stream or checks a return code
    itself: every C entry point is called by _build.launch."""
    for path in _python_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "stream_ptr", "check", "cuda_stream") and isinstance(
                    node.value, ast.Name) and node.value.id == "_build":
                pytest.fail(f"{path}:{node.lineno} calls _build.{node.attr}")


# --- the batch pipelines over a mesh ----------------------------------------

@pytest.fixture(scope="module")
def decoded():
    """The mixed list (icons, SQOA, .qoi, a REF stream, bad headers), its
    decode without a mesh, and the JAX BatchDecoder's on 8 devices."""
    streams = _mixed()
    return (streams, st.BatchDecoder(device="cpu")(streams),
            jbatch.BatchDecoder(jax_mesh())(streams))


@pytest.mark.parametrize("k", _KS)
def test_batch_decoder_is_mesh_invariant(decoded, k, monkeypatch):
    streams, alone, theirs = decoded
    mesh = _cpu_mesh(k)
    parts = []
    dispatch = batch.BatchDecoder._dispatch
    monkeypatch.setattr(
        batch.BatchDecoder, "_dispatch",
        lambda self, items, key, dev: parts.append((key, len(items), dev))
        or dispatch(self, items, key, dev))
    dec = st.BatchDecoder(mesh=mesh)
    ours = dec(streams)
    _same(ours, streams)
    for i, (a, b, c) in enumerate(zip(ours, alone, theirs)):
        assert a.error == b.error and (a.pixels is None) == (c.pixels is None)
        if a.pixels is not None:
            assert np.array_equal(a.pixels, b.pixels), i
            assert np.array_equal(a.pixels, np.asarray(c.pixels)), i
    # each class went out in batch_sharding's parts, one per mesh entry
    sizes = {}
    for key, n, _ in parts:
        sizes.setdefault(key, []).append(n)
    for key, got in sizes.items():
        want = [hi - lo for _, lo, hi in batch_sharding(mesh, sum(got))]
        assert got == want, key
    assert dec.last_stats["host_rows"] == 1  # the REF stream


@pytest.fixture(scope="module")
def encoded():
    rng = np.random.default_rng(31)
    images, descs = [], []
    for ch in (1, 2, 3, 4, 5, 6):
        im, de = _enc_list(rng, ch)
        images += im
        descs += de
    theirs = jbatch.BatchEncoder(jax_mesh())(images, [
        sq.SqoaDesc(d.width, d.height, d.channels, d.colorspace,
                    d.qoi_compat) for d in descs])
    return images, descs, st.BatchEncoder(device="cpu")(images, descs), theirs


@pytest.mark.parametrize("k", _KS)
def test_batch_encoder_is_mesh_invariant(encoded, k):
    images, descs, alone, theirs = encoded
    ours = st.BatchEncoder(mesh=_cpu_mesh(k))(images, descs)
    assert ours == alone == theirs == _native_enc(images, descs)


def test_corpus_functions_take_a_mesh(decoded, encoded):
    streams, alone, _ = decoded
    got = st.corpus_decode(streams, mesh=_cpu_mesh(3))
    assert [r.error for r in got] == [r.error for r in alone]
    images, descs, enc_alone, _ = encoded
    assert st.corpus_encode(images, descs, mesh=_cpu_mesh(3)) == enc_alone


# --- large images over a mesh -----------------------------------------------

_N = 8 * 32768 + 1234  # tests/test_sharding.py's shard-map image


@pytest.fixture(scope="module")
def large():
    """The striped image, its native stream, and the JAX package's four
    large-image functions on its 8-device mesh."""
    pix = _striped(np.random.default_rng(5), _N)
    stream = native.encode(pix, _N, 1, 3, 0, 0)
    m8 = jax_mesh(jax.devices(), axis="s")
    jdesc = sq.SqoaDesc(_N, 1, 3)
    theirs = (jtiled.encode_large(pix, jdesc, m8),
              jtiled.encode_large_shardmap(pix, jdesc, m8),
              np.asarray(jtiled.decode_large(stream, 0, m8)[0]),
              np.asarray(jtiled.decode_large_shardmap(stream, 0, m8)[0]))
    return pix, stream, theirs


@pytest.mark.parametrize("k", _KS)
def test_large_image_functions_are_mesh_invariant(large, k):
    pix, stream, (j_enc, j_enc_sm, j_dec, j_dec_sm) = large
    mesh = _cpu_mesh(k)
    desc = st.SqoaDesc(_N, 1, 3)
    assert j_enc == j_enc_sm == stream
    assert st.encode_large(pix, desc, mesh=mesh) == stream
    assert st.encode_large_shardmap(pix, desc, mesh=mesh) == stream
    for fn in (st.decode_large, st.decode_large_shardmap):
        ours, d = fn(stream, 0, mesh=mesh)
        assert np.array_equal(ours, pix) and d.width == _N
    assert np.array_equal(j_dec, pix) and np.array_equal(j_dec_sm, pix)


@pytest.mark.parametrize("ch,kind", [(4, "alpha_churn"), (1, "long_runs")])
def test_shard_forms_on_a_mesh_that_repeats_devices(ch, kind):
    """Shards of one device run as one batch even where the mesh interleaves
    its devices: rows 0 and 2 on one entry's device, 1 and 3 on the other,
    with forced channels and shards past the image's end."""
    w, h = 512, 96
    stride = (1 if ch < 3 else 3) + (1 - (ch & 1))
    pix = gen_pixels(np.random.default_rng(ch), w * h, stride, kind)
    stream = native.encode(pix, w, h, ch, 0, 0)
    desc = st.SqoaDesc(w, h, ch)
    meta = torch.device("cpu", 0)  # a second name of the CPU device
    mesh = default_mesh([_CPU, meta, _CPU, meta])
    assert st.encode_large_shardmap(pix, desc, mesh=mesh) == stream
    for fch in (0, 4):
        ours, _ = st.decode_large_shardmap(stream, fch, mesh=mesh)
        assert np.array_equal(ours, native.decode(stream, fch)[0])
