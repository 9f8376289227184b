"""K3 (encode front-end): the port's plain version against the Pallas kernel.

The Pallas kernel runs in interpret mode in a subprocess; the port's
``encode_front_compact`` runs its plain PyTorch version on the CPU, on the
same seeded packed pixels. Exact comparison (tolerance 0) of the entry,
byte and last-change scalars and of the (offset, pixel, meta) entries
below the entry totals.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import gen_pixels
from seqoia_tpu_torch import convert, spec
from seqoia_tpu_torch.codec.encode import normalize_pixels_packed
from seqoia_tpu_torch.ops import encode_front

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_encode

inp = np.load(sys.argv[1])
out = {}
for name in [str(n) for n in inp["names"]]:
    px = jnp.asarray(inp[name + "/packed"])
    keys, pays, et, ct, lc = pallas_encode.encode_front_compact(
        px, jnp.asarray(inp[name + "/nv"]), colch=int(inp[name + "/colch"]),
        init_prev=jnp.asarray(inp[name + "/init_prev"]),
        lc0=jnp.asarray(inp[name + "/lc0"]), rows=px.shape[1] // 128)
    out[name + "/k3"] = np.stack([np.asarray(keys)] + [np.asarray(p) for p in pays])
    out[name + "/scal"] = np.stack([np.asarray(et), np.asarray(ct), np.asarray(lc)])
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def _rows(rng, ch, n, specs):
    desc_ch = spec.SqoaDesc(1, 1, ch, 0, 0)
    out = []
    for kind, nv in specs:
        d = spec.SqoaDesc(nv, 1, ch, 0, 0)
        px = normalize_pixels_packed(
            gen_pixels(rng, nv, desc_ch.norm_channels, kind), d)
        out.append(np.pad(px, (0, n - nv), constant_values=12345))
    return np.stack(out)


def _cases():
    rng = np.random.default_rng(5)
    init = encode_front.INIT_PACKED
    cases = {}
    for name, ch, n, specs, ip, lc0 in (
            ("rgb_4096", 3, 4096, [("noise", 4096), ("luma", 3000)],
             [init, init], [-1, -1]),
            ("rgba_runs_16384", 4, 16384,
             [("long_runs", 16384), ("alpha_churn", 9000)],
             [init, init], [-1, -1]),
            ("gray_4096", 1, 4096, [("luma", 4096), ("long_runs", 4000)],
             [init, init], [-1, -1]),
            ("gray_alpha_16384", 2, 16384,
             [("alpha_churn", 10000), ("sparse_delta", 16384)],
             [init, init], [-1, -1]),
            # a shard of a larger image: a carried pixel and run
            ("rgb_shard_4096", 3, 4096, [("long_runs", 4096), ("palette", 4096)],
             [0x00102030, init], [-301, -1])):
        cases[name] = dict(
            packed=_rows(rng, ch, n, specs),
            nv=np.array([nv for _, nv in specs], np.int32),
            colch=1 if ch < 3 else 3,
            init_prev=np.array(ip, np.int32), lc0=np.array(lc0, np.int32))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k3")
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
def test_encode_front_plain_matches_pallas(name, pallas_out):
    c = CASES[name]
    keys, (cur, meta), et, ct, lc = encode_front.encode_front_compact(
        torch.from_numpy(c["packed"]), torch.from_numpy(c["nv"]),
        colch=c["colch"], init_prev=torch.from_numpy(c["init_prev"]),
        lc0=torch.from_numpy(c["lc0"]))
    k, p0, p1 = pallas_out[name + "/k3"]
    wk, (wc, wm), wet, wct, wlc = convert.encode_front(
        k, [p0, p1], *pallas_out[name + "/scal"])
    assert torch.equal(et, wet) and torch.equal(ct, wct), (et, wet, ct, wct)
    assert torch.equal(lc, wlc), (lc, wlc)
    for r, t in enumerate(et.tolist()):
        assert torch.equal(keys[r, :t], wk[r, :t]), f"row {r} offsets"
        assert torch.equal(cur[r, :t], wc[r, :t]), f"row {r} pixels"
        assert torch.equal(meta[r, :t], wm[r, :t]), f"row {r} meta"


def test_encode_front_bigrun_chain():
    """A row of 1301 equal pixels (r=200, opaque): an RGB op at the first,
    then a BIGRUN every 512 repeats, and the byte total counts them."""
    px = torch.full((1, 1301), 200 - 2**24, dtype=torch.int32)
    keys, (cur, meta), et, ct, lc = encode_front.encode_front_compact(
        px, torch.tensor([1301], dtype=torch.int32), colch=3)
    cls = (meta[0, : int(et[0])] >> 9) & 7
    assert int(et[0]) == 3 and int(lc[0]) == 0
    assert cls.tolist() == [encode_front.CL_RGB, encode_front.CL_NONE,
                            encode_front.CL_NONE]
    assert keys[0, :3].tolist() == [0, 4, 5] and int(ct[0]) == 6
