"""The port's switches against the JAX package's, on the CPU:
``SEQOIA_FIXPOINT_ITERS`` (the ``.qoi`` fixpoint's cap), the ``.qoi``
batch policy ``SEQOIA_COMPAT_CUDA`` (the JAX package's
``SEQOIA_COMPAT_TPU``) and the ``seqoia-tpu-torch`` console script.

Both packages read the cap at import, and the JAX fixpoint runs only with
its Pallas kernels in interpret mode (``fixpoint_ok``), so each cap runs in
a subprocess of its own that imports both with the variable set. The
policy's streams are tests/test_compat_probe.py's: an INDEX chain deeper
than the cap and three streams of unique colors. Pixels are compared
exactly (tolerance 0) with each other and with the native codec.
"""

import importlib
import os
import subprocess
import sys
import threading
import tomllib

import numpy as np
import pytest
import torch

import seqoia_tpu_torch as st
from seqoia_tpu import native
from seqoia_tpu.parallel import batch as jbatch
from seqoia_tpu_torch.parallel import batch

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_M = 32768  # the JAX fixpoint's tile: a row of the batch


def _chain(links: int):
    """tests/test_compat_fixpoint.py's INDEX chain with ``links`` links:
    color A hashes to slot 0, where the fixpoint's wrong guesses land too,
    and alternates with unique fillers, so each repeat of A reads the one
    before and the fixpoint settles one link a pass."""
    a = (25, 0, 0, 255)
    pixels, c = [a], 2
    while len(pixels) < 2 * links + 1:
        if c != 43:  # this filler would hash to slot 0
            pixels += [(c, 40, 0, 255), a]
        c += 1
    return np.array(pixels, np.uint8).reshape(-1), len(pixels)


# rows that settle after 1, 2, 6 and 62 resolutions
_LINKS = (0, 1, 5, 61)

_SCRIPT = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import torch
from seqoia_tpu.codec import decode_compat as jdc
from seqoia_tpu_torch.codec import decode_compat as tdc

cap = int(os.environ["SEQOIA_FIXPOINT_ITERS"])
assert jdc._MAX_ITERS == tdc._MAX_ITERS == cap
inp = np.load(sys.argv[1])
kw = dict(colch=3, out_ch=4, n_max=int(inp["n_max"]))
px, conv = jdc.decode_stream_compat_batched(
    jnp.asarray(inp["data"]), jnp.asarray(inp["clen"]),
    jnp.asarray(inp["npx"]), **kw)
stats = {}
tpx, tconv = tdc.decode_stream_compat_batched(
    torch.from_numpy(inp["data"]), torch.from_numpy(inp["clen"]),
    torch.from_numpy(inp["npx"]), stats=stats, **kw)
np.savez(sys.argv[2], jpx=np.asarray(px), jconv=np.asarray(conv),
         tpx=tpx.numpy(), tconv=tconv.numpy(), passes=stats["passes"])
print("CAP-OK")
"""


_CAPS = (1, 2, 12)


@pytest.fixture(scope="module", autouse=True)
def cap_runs(tmp_path_factory):
    """One subprocess a cap, all started with the module's first test, so
    that they run beside its other tests: {cap: (process, output path)};
    the rows' pixels."""
    d = tmp_path_factory.mktemp("caps")
    streams, pixels = [], []
    for links in _LINKS:
        pix, n = _chain(links)
        streams.append(native.encode(pix, n, 1, 4, 0, 1))
        pixels.append(pix)
    data = np.zeros((len(streams), _M), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    np.savez(d / "in.npz", data=data, n_max=np.int32(128),
             clen=np.array([len(s) - 8 for s in streams], np.int32),
             npx=np.array([len(p) // 4 for p in pixels], np.int32))
    runs = {}
    for cap in _CAPS:
        env = dict(os.environ, SEQOIA_PALLAS_INTERPRET="1",
                   SEQOIA_FIXPOINT_ITERS=str(cap), JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [_ROOT, os.environ.get("PYTHONPATH", "")]))
        out = d / f"out{cap}.npz"
        runs[cap] = (subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env), out)
    yield runs, pixels
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


# --- the .qoi batch policy -------------------------------------------------

def _probe_streams():
    """tests/test_compat_probe.py's streams: a 61-link INDEX chain (probe
    depth past the cap), three streams of unique colors (depth 0); then a
    mono .qoi stream (its header's channels byte set to 1) and a SQOA
    stream, which no .qoi policy moves."""
    deep_pix, n = _chain(61)
    streams = [native.encode(deep_pix, n, 1, 4, 0, 1)]
    for k in range(3):
        i = np.arange(64 * 32, dtype=np.int32)
        p = np.stack([i % 256, (i // 256 + 40 * k) % 256,
                      np.full_like(i, 37 + k), np.full_like(i, 255)],
                     axis=1).astype(np.uint8).ravel()
        streams.append(native.encode(p, 64, 32, 4, 0, 1))
    mono = bytearray(native.encode(np.arange(900, dtype=np.uint8) % 7, 20,
                                   15, 3, 0, 1))
    mono[12] = 1
    streams.append(bytes(mono))
    streams.append(native.encode(deep_pix, n, 1, 4, 0, 0))
    return streams


def _spy(monkeypatch, cls):
    """Record the indices and threads of cls._host_pool's calls."""
    hosted = []
    pool = cls._host_pool

    def spy(items, channels, results):
        hosted.append(([i for i, _ in items], threading.current_thread()))
        return pool(items, channels, results)
    monkeypatch.setattr(cls, "_host_pool", staticmethod(spy))
    return hosted


def _decode(monkeypatch, mode, streams, **kw):
    """The port's BatchDecoder under SEQOIA_COMPAT_CUDA=mode (None: unset):
    (results, stats, [(hosted indices, thread)])."""
    if mode is None:
        monkeypatch.delenv("SEQOIA_COMPAT_CUDA", raising=False)
    else:
        monkeypatch.setenv("SEQOIA_COMPAT_CUDA", mode)
    hosted = _spy(monkeypatch, batch.BatchDecoder)
    dec = st.BatchDecoder(device="cpu", **kw)
    out = dec(streams)
    for i, (r, s) in enumerate(zip(out, streams)):
        want, _ = native.decode(s, 0)
        assert np.array_equal(r.pixels, want), (mode, i)
    return out, dec.last_stats, hosted


def test_auto_hosts_what_the_jax_auto_hosts(monkeypatch):
    streams = _probe_streams()
    monkeypatch.setenv("SEQOIA_COMPAT_TPU", "auto")
    theirs_hosted = _spy(monkeypatch, jbatch.BatchDecoder)
    jdec = jbatch.BatchDecoder()
    theirs = jdec(streams)
    ours, stats, hosted = _decode(monkeypatch, "auto", streams)
    want = sorted(i for ids, _ in theirs_hosted for i in ids)
    assert want == [0, 4]  # the deep chain and the mono stream
    assert sorted(i for ids, _ in hosted for i in ids) == want
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.pixels, np.asarray(b.pixels))
    assert (stats["auto_cuda"], stats["auto_host"]) == (
        jdec.last_stats["auto_tpu"], jdec.last_stats["auto_host"]) == (3, 1)
    assert stats["host_rows"] == 2


def test_zero_hosts_every_qoi_stream_one_none(monkeypatch):
    streams = _probe_streams()
    _, stats, hosted = _decode(monkeypatch, "0", streams)
    assert sorted(i for ids, _ in hosted for i in ids) == [0, 1, 2, 3, 4]
    assert stats["host_rows"] == 5 and "auto_cuda" not in stats
    _, stats, hosted = _decode(monkeypatch, "1", streams)
    assert hosted == [] and stats["host_rows"] == 0


def test_unset_takes_the_measured_default(monkeypatch):
    streams = _probe_streams()
    _, stats, _ = _decode(monkeypatch, None, streams)
    assert batch._COMPAT_DEFAULT in ("0", "1")
    assert stats["host_rows"] == (5 if batch._COMPAT_DEFAULT == "0" else 0)
    _, empty, _ = _decode(monkeypatch, "", streams)
    assert empty == stats
    monkeypatch.setenv("SEQOIA_COMPAT_CUDA", "yes")
    with pytest.raises(ValueError, match="SEQOIA_COMPAT_CUDA"):
        st.BatchDecoder(device="cpu")(streams)


def test_the_host_pool_overlaps_the_queued_classes(monkeypatch):
    """With device work queued and more than one core, the .qoi streams go
    to the host pool on a thread of their own; with nothing queued, or one
    core, inline."""
    streams = _probe_streams()
    here = threading.current_thread()
    monkeypatch.setattr(batch.os, "cpu_count", lambda: 8)
    _, _, hosted = _decode(monkeypatch, "0", streams)
    assert len(hosted) == 1 and hosted[0][1] is not here
    _, _, hosted = _decode(monkeypatch, "0", streams[:5])  # nothing queued
    assert len(hosted) == 1 and hosted[0][1] is here
    monkeypatch.setattr(batch.os, "cpu_count", lambda: 1)
    _, _, hosted = _decode(monkeypatch, "0", streams)
    assert len(hosted) == 1 and hosted[0][1] is here


def test_the_policy_holds_on_a_mesh(monkeypatch):
    streams = _probe_streams()
    mesh = st.parallel.default_mesh(["cpu"] * 3)
    _, stats, hosted = _decode(monkeypatch, "auto", streams, mesh=mesh)
    assert sorted(i for ids, _ in hosted for i in ids) == [0, 4]
    assert (stats["auto_cuda"], stats["auto_host"]) == (3, 1)


# --- the console script -----------------------------------------------------

def test_console_script_resolves_to_the_cli(tmp_path):
    with open(os.path.join(_ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    target = scripts["seqoia-tpu-torch"]
    assert target == "seqoia_tpu_torch.cli:main"
    mod, attr = target.split(":")
    main = getattr(importlib.import_module(mod), attr)
    from seqoia_tpu_torch import cli

    assert main is cli.main
    assert main(["corpus", str(tmp_path), "--scale", "0.02"]) == 0
    assert sorted(os.listdir(tmp_path))[0] == "img_000.png"


# --- the fixpoint's cap (the subprocesses started above) ---------------------

@pytest.mark.parametrize("cap", _CAPS)
def test_fixpoint_cap_matches_jax(cap, cap_runs):
    runs, pixels = cap_runs
    proc, path = runs[cap]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "CAP-OK" in stdout, stderr[-3000:]
    out = np.load(path)
    # the first resolution always runs; a row settles on the pass after
    # its last link, so the cap decides which rows are flagged
    want = [links + 1 <= max(cap, 1) for links in _LINKS]
    assert out["jconv"].tolist() == out["tconv"].tolist() == want
    assert int(out["passes"]) == max(1, min(cap, _LINKS[-1] + 1))
    for i, (pix, conv) in enumerate(zip(pixels, want)):
        n = len(pix)
        assert np.array_equal(out["tpx"][i, :n], pix), i
        if conv:  # the JAX package hands its other rows to the host
            assert np.array_equal(out["jpx"][i, :n], pix), i
