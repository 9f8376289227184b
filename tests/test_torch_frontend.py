"""K1 (decode front-end): the port's plain version against the Pallas kernel.

The Pallas kernel runs in interpret mode in a subprocess (the flag must be
set before seqoia_tpu loads); the port's ``decode_front_compact`` runs its
plain PyTorch version on the CPU. Both see the same (B, M) byte buffers,
made from a seed with numpy and the native encoder. The comparison is
exact (integer codec, tolerance 0) over the valid region: the totals, the
REF/foreign flags, and the keys and payloads below totals.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import gen_pixels
from seqoia_tpu import native
from seqoia_tpu_torch import convert
from seqoia_tpu_torch.ops import frontend

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_frontend

inp = np.load(sys.argv[1])
out = {}
for name in [str(n) for n in inp["names"]]:
    data = inp[name + "/data"]
    keys, pays, totals, has_ref = pallas_frontend.decode_front_compact(
        jnp.asarray(data), jnp.asarray(inp[name + "/clen"]),
        int(inp[name + "/n_max"]), mode=str(inp[name + "/mode"]),
        rows=data.shape[1] // 128)
    out[name + "/keys"] = np.asarray(keys)
    out[name + "/pays"] = np.asarray(pays[0])
    out[name + "/totals"] = np.asarray(totals)
    out[name + "/has_ref"] = np.asarray(has_ref)
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def _stream(rng, w, h, ch, kind):
    stride = (1 if ch < 3 else 3) + (1 - (ch & 1))
    return native.encode(gen_pixels(rng, w * h, stride, kind), w, h, ch, 0, 0)


def _case(streams, m, mode, n_max, clen=None):
    data = np.zeros((len(streams), m), np.uint8)
    for i, s in enumerate(streams):
        assert len(s) <= m, (len(s), m)
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    if clen is None:
        clen = [len(s) - 8 for s in streams]
    return dict(data=data, clen=np.asarray(clen, np.int32), mode=mode,
                n_max=n_max)


def _cases():
    rng = np.random.default_rng(7)
    cases = {}
    # RGBA with alpha modifiers, and a BIGRUN chain (runs > 512 px)
    cases["alpha_runs_4096"] = _case(
        [_stream(rng, 24, 24, 4, "luma"), _stream(rng, 64, 64, 4, "long_runs")],
        4096, "alpha", 4096)
    pa = gen_pixels(rng, 28 * 28, 4, "sparse_delta").reshape(-1, 4)
    pa[:, 3] = 255 - (rng.random(28 * 28) < 0.2) * rng.integers(1, 12, 28 * 28)
    cases["alpha_mods_16384"] = _case(
        [native.encode(pa.ravel(), 28, 28, 4, 0, 0),
         _stream(rng, 60, 50, 4, "alpha_churn")], 16384, "alpha", 4096)
    # alpha-less color; n_max below the image cuts the totals
    cases["noalpha_16384"] = _case(
        [_stream(rng, 60, 60, 3, "noise"), _stream(rng, 70, 50, 3, "sparse_delta")],
        16384, "noalpha", 2048)
    # mono grammar: gray, and gray + alpha
    cases["mono_4096"] = _case(
        [_stream(rng, 40, 40, 1, "luma"), _stream(rng, 30, 30, 2, "noise")],
        4096, "mono", 2048)
    cases["mono_runs_16384"] = _case(
        [_stream(rng, 90, 90, 1, "long_runs"), _stream(rng, 50, 50, 2, "alpha_churn")],
        16384, "mono", 8192)
    # a foreign stream: alpha tokens in a stream decoded as alpha-less
    cases["foreign_noalpha_4096"] = _case(
        [_stream(rng, 20, 20, 4, "alpha_churn"), _stream(rng, 20, 20, 3, "luma")],
        4096, "noalpha", 512)
    # a REF op (tags 0x00-0x5f) at the first op position
    ref = bytearray(_stream(rng, 30, 30, 4, "luma"))
    ref[15] = 0x05
    cases["ref_alpha_4096"] = _case(
        [bytes(ref), _stream(rng, 30, 30, 4, "palette")], 4096, "alpha", 4096)
    # truncated streams: the byte count stops mid-stream
    s0, s1 = _stream(rng, 50, 50, 4, "noise"), _stream(rng, 60, 60, 3, "luma")
    cases["truncated_16384"] = _case(
        [s0, s1], 16384, "alpha", 4096, clen=[len(s0) // 2, len(s1) // 3 + 1])
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k1")
    arrays = {"names": np.array(list(CASES))}
    for name, c in CASES.items():
        for k, v in c.items():
            arrays[f"{name}/{k}"] = np.asarray(v)
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=600)
    assert "PALLAS-OK" in res.stdout, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("name", list(CASES))
def test_front_plain_matches_pallas(name, pallas_out):
    c = CASES[name]
    keys, pays, totals, has_ref = frontend.decode_front_compact(
        torch.from_numpy(c["data"]), torch.from_numpy(c["clen"]), c["n_max"],
        mode=c["mode"])
    want = convert.decode_front(
        pallas_out[name + "/keys"], [pallas_out[name + "/pays"]],
        pallas_out[name + "/totals"], pallas_out[name + "/has_ref"])
    assert torch.equal(totals, want[2]), (totals, want[2])
    assert torch.equal(has_ref, want[3]), (has_ref, want[3])
    for r, t in enumerate(totals.tolist()):
        assert torch.equal(keys[r, :t], want[0][r, :t]), f"row {r} keys"
        assert torch.equal(pays[r, :t], want[1][r, :t]), f"row {r} payloads"


def test_front_flags_and_cuts():
    """The cases above hit what they are meant to: foreign and REF rows are
    flagged, clean rows are not, and n_max cuts the op count."""
    def run(name):
        c = CASES[name]
        return frontend.decode_front_compact(
            torch.from_numpy(c["data"]), torch.from_numpy(c["clen"]),
            c["n_max"], mode=c["mode"])

    assert run("foreign_noalpha_4096")[3].tolist() == [1, 0]
    assert run("ref_alpha_4096")[3].tolist() == [1, 0]
    assert run("alpha_runs_4096")[3].tolist() == [0, 0]
    keys, _, totals, _ = run("noalpha_16384")
    assert int(keys[0, int(totals[0]) - 1]) < 2048
    full = frontend.decode_front_compact(
        torch.from_numpy(CASES["noalpha_16384"]["data"]),
        torch.from_numpy(CASES["noalpha_16384"]["clen"]), 8192,
        mode="noalpha")[2]
    assert (full > totals).all()


@pytest.mark.parametrize("block", [16, 1000, 4096])
@pytest.mark.parametrize("name", ["alpha_mods_16384", "noalpha_16384",
                                  "mono_runs_16384", "truncated_16384"])
def test_front_plain_blocks_carry_the_scans(name, block):
    """The plain version walks a long row in blocks and carries the
    automaton's state, the pixel offset and the channel sums: any block
    length, aligned to the ops or not, gives the result of one block."""
    c = CASES[name]
    data, clen = torch.from_numpy(c["data"]), torch.from_numpy(c["clen"])
    whole = frontend.decode_front_plain(data, clen, c["n_max"], c["mode"],
                                        block=data.shape[1])
    parts = frontend.decode_front_plain(data, clen, c["n_max"], c["mode"],
                                        block=block)
    for got, want in zip(parts, whole):
        assert torch.equal(got, want)
