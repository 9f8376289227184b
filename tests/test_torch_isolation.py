"""The port stands alone: it imports neither JAX nor the JAX package, runs on
the card unless the caller asks for the CPU, and chip_smoke.py refuses to
run without a card."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import seqoia_tpu_torch as st
from seqoia_tpu_torch.ops import encode_front, engine, frontend, pack

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(_ROOT, "seqoia_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_port_imports_no_jax(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "seqoia_tpu"), (path, mod)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_default_to_the_card():
    _no_card()
    stream = st.native.encode(np.zeros(12, np.uint8), 2, 2, 3, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.decode(stream)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.encode(np.zeros(12, np.uint8), st.SqoaDesc(2, 2, 3))
    # the host codec needs no device
    px, _ = st.decode(stream, backend="native")
    assert px.tolist() == [0] * 12


def test_large_and_batch_entry_points_default_to_the_card():
    _no_card()
    pixels, desc = np.zeros(12, np.uint8), st.SqoaDesc(2, 2, 3)
    stream = st.native.encode(pixels, 2, 2, 3, 0, 0)
    for call in (
            lambda **kw: st.encode_large(pixels, desc, **kw),
            lambda **kw: st.encode_large_shardmap(pixels, desc, **kw),
            lambda **kw: st.decode_large(stream, **kw),
            lambda **kw: st.decode_large_shardmap(stream, **kw),
            lambda **kw: st.BatchDecoder(**kw),
            lambda **kw: st.corpus_decode([stream], **kw),
            lambda **kw: pack.normalize_pixels_device(pixels, desc, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    assert st.encode_large(pixels, desc, device="cpu") == stream
    assert st.BatchDecoder(device="cpu")([stream])[0].pixels.tolist() == [0] * 12


def test_wrappers_take_cpu_or_cuda_tensors_only():
    data = torch.zeros((1, 64), dtype=torch.uint8, device="meta")
    clen = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        frontend.decode_front_compact(data, clen, 16)
    keys = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        engine.place_fill(keys, [keys], clen, 16, (0,))
    with pytest.raises(ValueError, match="int32"):
        encode_front.encode_front_compact(data, clen)
    with pytest.raises(ValueError, match="device"):
        pack.pack_words(torch.zeros((1, 12), dtype=torch.int32, device="meta"),
                        3)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    _no_card()
    env = dict(os.environ)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone, without the rest of the repository
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
