"""K4 (raw bytes -> packed pixels): the port's plain version against the JAX
package's host normalization and against the Pallas kernel.

``normalize_pixels_device`` and ``pack_words`` run their plain PyTorch
version on the CPU; the Pallas kernel runs in interpret mode in a subprocess
(the flag must be set before seqoia_tpu loads). Inputs are made from a seed
with numpy; the comparison is exact (integer codec, tolerance 0).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from seqoia_tpu.codec import encode_jax
from seqoia_tpu_torch.ops import pack

# one thread per process: the suite runs several workers, and the plain
# versions' many small tensor ops only contend when each takes every core
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_pack

inp = np.load(sys.argv[1])
out = {}
for stride in (1, 2, 3):
    words = inp[f"words{stride}"]
    out[f"packed{stride}"] = np.asarray(
        pallas_pack.pack_words(jnp.asarray(words), stride))
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""

# pixels per padding tile, and the padding pixel per stride
_PAD_PIXEL = {1: -16777216, 2: 0, 3: -16777216, 4: 0}


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [1, 1000, 32768, 40001])
def test_normalize_matches_jax_host(channels, n):
    rng = np.random.default_rng(100 * channels + n % 97)
    desc = st.SqoaDesc(n, 1, channels)
    stride = desc.norm_channels
    pixels = rng.integers(0, 256, n * stride, dtype=np.uint8)
    got = pack.normalize_pixels_device(pixels, desc, device="cpu")
    want = encode_jax.normalize_pixels_packed(
        pixels, sq.SqoaDesc(n, 1, channels))
    n_pad = -(-n // 32768) * 32768
    assert got.shape == (n_pad,) and got.dtype == torch.int32
    assert np.array_equal(got[:n].numpy(), want)
    assert (got[n:] == _PAD_PIXEL[stride]).all()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k4")
    rng = np.random.default_rng(4)
    arrays = {
        f"words{s}": rng.integers(0, 256, (2, 32768 * s), dtype=np.uint8)
        .view("<i4") for s in (1, 2, 3)}
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=600)
    assert "PALLAS-OK" in res.stdout, res.stdout + res.stderr
    return arrays, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_pack_plain_matches_pallas(stride, pallas_out):
    arrays, out = pallas_out
    words = torch.from_numpy(arrays[f"words{stride}"].copy())
    got = pack.pack_words(words, stride)
    assert got.shape == (2, 32768)
    assert np.array_equal(got.numpy(), out[f"packed{stride}"])


def test_pack_words_rejects_bad_arguments():
    words = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="stride"):
        pack.pack_words(words, 4)
    with pytest.raises(ValueError, match="int32"):
        pack.pack_words(words.to(torch.uint8), 3)
    with pytest.raises(ValueError, match="groups of 4"):
        pack.pack_words(torch.zeros((1, 4), dtype=torch.int32), 3)
