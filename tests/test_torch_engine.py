"""K2 place_emit (each epilogue) and K6 place_fill: the port's plain versions
against the Pallas kernels, one stage swapped at a time.

A subprocess runs the JAX side with the Pallas kernels in interpret mode:
K1 (or K3) on seeded streams (or pixels), then K2/K6 on its output. The
port takes the same K1/K3 output — converted by ``seqoia_tpu_torch.convert``
— through its own ``place_emit`` / ``place_fill`` on the CPU (the plain
versions) and must give the same output exactly: K2 over its whole output
(the epilogues zero everything past the live region), K6 over the live
pixels (past them the TPU kernel's fill stops after max_gap slots, the
port's does not).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import gen_pixels
from seqoia_tpu import native
from seqoia_tpu_torch import convert, spec
from seqoia_tpu_torch.codec import decode_v2, encode_v2
from seqoia_tpu_torch.codec.encode import normalize_pixels_packed
from seqoia_tpu_torch.ops import engine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.codec import decode_v2, encode_v2
from seqoia_tpu.ops import pallas_encode, pallas_engine, pallas_frontend

inp = np.load(sys.argv[1])
out = {}
init = int(np.int32(np.uint32(255 << 24)))
for name in ("color", "mono"):
    data = jnp.asarray(inp[name + "/data"])
    n_max = int(inp[name + "/n_max"])
    m = data.shape[1]
    k, p, t, r = pallas_frontend.decode_front_compact(
        data, jnp.asarray(inp[name + "/clen"]), n_max,
        mode="alpha" if name == "color" else "mono", rows=m // 128)
    out[name + "/k1"] = np.stack([np.asarray(k), np.asarray(p[0])])
    out[name + "/totals"] = np.asarray(t)
    npx = jnp.asarray(inp[name + "/npx"])[:, None]
    for och in ((3, 4) if name == "color" else (1, 2)):
        if name == "color":
            rows = n_max // 128
            o = pallas_engine.place_emit(
                k, p, t, npx, n_max, (init,), decode_v2._dec_epilogue(och),
                p_out=n_max, out_rows=rows if och == 4 else rows * 3 // 4,
                out_dtype=jnp.int32, entry_limit=m, max_gap=511)
        else:
            o = pallas_engine.place_emit(
                k, p, t, npx, n_max, (init,), decode_v2._dec_epilogue_mono(och),
                p_out=n_max, out_dtype=jnp.uint8 if och == 1 else jnp.uint16,
                entry_limit=m, max_gap=511)
        out[f"{name}/emit{och}"] = np.asarray(o)
    out[name + "/fill"] = np.asarray(pallas_engine.place_fill(
        k, p, t, n_max, (init,), p_out=n_max, max_gap=511)[0])
for name, colch in (("enc3", 3), ("enc1", 1)):
    px = jnp.asarray(inp[name + "/packed"])
    nv = jnp.asarray(inp[name + "/nv"])
    n = px.shape[1]
    keys, pays, et, ct, lc = pallas_encode.encode_front_compact(
        px, nv, colch=colch, rows=n // 128)
    out[name + "/k3"] = np.stack([np.asarray(keys)] + [np.asarray(x) for x in pays])
    out[name + "/scal"] = np.stack([np.asarray(et), np.asarray(ct), np.asarray(lc)])
    trail = ((((nv - 1) - lc) % 512 > 0) & (nv > 0)).astype(jnp.int32)
    scal = jnp.stack([ct, trail, jnp.ones_like(ct)], axis=-1)
    cap = int(inp[name + "/cap"])
    o = pallas_engine.place_emit(
        keys, list(pays), et, scal, cap, encode_v2._emit_inits(colch),
        encode_v2._emit_epilogue(colch), max_gap=14, p_out=2048,
        fill_keys=True, entry_limit=n)
    out[name + "/emit"] = np.asarray(o)
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""

_INIT = -16777216


def _inputs():
    rng = np.random.default_rng(11)
    inp = {}
    for name, ch, shapes, m in (
            ("color", 4, [(40, 40, "luma"), (48, 30, "long_runs")], 8192),
            ("mono", 2, [(40, 40, "noise"), (45, 45, "long_runs")], 8192)):
        stride = (1 if ch < 3 else 3) + 1
        streams = [native.encode(gen_pixels(rng, w * h, stride, kind), w, h,
                                 ch, 0, 0) for w, h, kind in shapes]
        data = np.zeros((2, m), np.uint8)
        for i, s in enumerate(streams):
            assert len(s) <= m
            data[i, : len(s)] = np.frombuffer(s, np.uint8)
        inp[name + "/data"] = data
        inp[name + "/clen"] = np.array([len(s) - 8 for s in streams], np.int32)
        inp[name + "/npx"] = np.array([w * h for w, h, _ in shapes], np.int32)
        inp[name + "/n_max"] = np.int32(2048)
    for name, ch, n, kinds in (("enc3", 4, 4096, ("noise", "long_runs")),
                               ("enc1", 2, 16384, ("alpha_churn", "long_runs"))):
        desc = spec.SqoaDesc(64, 64, ch, 0, 0)
        stride = desc.norm_channels
        nv = [64 * 64, 50 * 50]
        rows = []
        for k, v in zip(kinds, nv):
            d = spec.SqoaDesc(v, 1, ch, 0, 0)
            px = normalize_pixels_packed(gen_pixels(rng, v, stride, k), d)
            rows.append(np.pad(px, (0, n - v)))
        inp[name + "/packed"] = np.stack(rows)
        inp[name + "/nv"] = np.array(nv, np.int32)
        inp[name + "/cap"] = np.int32(spec.cap_bucket(n * (stride + 1) + 9))
    return inp


INPUTS = _inputs()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k2")
    np.savez(d / "in.npz", **INPUTS)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=600)
    assert "PALLAS-OK" in res.stdout, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _front(pallas_out, name):
    k, p = pallas_out[name + "/k1"]
    keys, pays, totals, _ = convert.decode_front(
        k, [p], pallas_out[name + "/totals"], np.zeros(2, np.int32))
    return keys, pays, totals


@pytest.mark.parametrize("name,out_ch", [("color", 3), ("color", 4),
                                         ("mono", 1), ("mono", 2)])
def test_place_emit_decode_matches_pallas(name, out_ch, pallas_out):
    keys, pays, totals = _front(pallas_out, name)
    npx = convert.tensor(INPUTS[name + "/npx"])[:, None]
    epi = (decode_v2._dec_epilogue(out_ch) if name == "color"
           else decode_v2._dec_epilogue_mono(out_ch))
    got = engine.place_emit(keys, [pays], totals, npx, 2048, (_INIT,), epi)
    want = pallas_out[f"{name}/emit{out_ch}"]
    assert got.dtype == epi.dtype
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["color", "mono"])
def test_place_fill_matches_pallas(name, pallas_out):
    keys, pays, totals = _front(pallas_out, name)
    (got,) = engine.place_fill(keys, [pays], totals, 2048, (_INIT,))
    want = pallas_out[name + "/fill"]
    for r, n in enumerate(INPUTS[name + "/npx"]):
        assert np.array_equal(got[r, :n].numpy(), want[r, :n]), f"row {r}"


@pytest.mark.parametrize("name,colch", [("enc3", 3), ("enc1", 1)])
def test_place_emit_encode_matches_pallas(name, colch, pallas_out):
    k, cur, meta = pallas_out[name + "/k3"]
    et, ct, lc = pallas_out[name + "/scal"]
    keys, (cur, meta), et, ct, lc = convert.encode_front(k, [cur, meta], et, ct,
                                                         lc)
    nv = convert.tensor(INPUTS[name + "/nv"])
    trail = ((((nv - 1) - lc) % 512 > 0) & (nv > 0)).to(torch.int32)
    scal = torch.stack([ct, trail, torch.ones_like(ct)], dim=-1)
    got = engine.place_emit(keys, [cur, meta], et, scal,
                            int(INPUTS[name + "/cap"]),
                            encode_v2._emit_inits(), encode_v2._emit_epilogue(colch))
    assert np.array_equal(got.numpy(), pallas_out[name + "/emit"])


def test_place_fill_streams_and_keys():
    """place_fill's contract on a hand-made stream: the last entry at or
    before each slot, the inits before the first, several payloads and the
    filled keys."""
    keys = torch.tensor([[2, 5, 6, 99, 7]], dtype=torch.int32)
    a = torch.tensor([[10, 11, 12, 13, 14]], dtype=torch.int32)
    b = -a
    totals = torch.tensor([3], dtype=torch.int32)
    fa, fb, fk = engine.place_fill(keys, [a, b], totals, 8, (-1, 1, 0),
                                   fill_keys=True)
    assert fa.tolist() == [[-1, -1, 10, 10, 10, 11, 12, 12]]
    assert fb.tolist() == [[1, 1, -10, -10, -10, -11, -12, -12]]
    assert fk.tolist() == [[0, 0, 2, 2, 2, 5, 6, 6]]


@pytest.mark.parametrize("start,n", [(0, 64), (20, 12), (60, 4)])
def test_plain_fill_by_slot_range(start, n):
    """A slot depends on no other, so the plain fill of a slot range is that
    range of the whole fill (how a long output is checked piece by piece)."""
    keys = torch.tensor([[3, 10, 40, 0], [0, 21, 22, 63]], dtype=torch.int32)
    pays = torch.tensor([[7, 8, 9, 0], [1, 2, 3, 4]], dtype=torch.int32)
    totals = torch.tensor([3, 4], dtype=torch.int32)
    (whole,) = engine._fill_plain(keys, [pays], totals, 64, (5,))
    (part,) = engine._fill_plain(keys, [pays], totals, n, (5,), start)
    assert torch.equal(part, whole[:, start: start + n])
    assert whole[0, :3].tolist() == [5, 5, 5] and int(whole[0, 63]) == 9
