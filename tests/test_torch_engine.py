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
    epi = (decode_v2._epilogue(3, out_ch) if name == "color"
           else decode_v2._epilogue(1, out_ch))
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


# --- the tiled kernel's design (csrc/engine.cu) ------------------------------

NT, SPT = 256, 16        # threads a block, consecutive slots a thread scans
TILE = NT * SPT          # slots a tile


def _count_le(keys, a, b, v):
    """count_le: a + #{keys[a:b] <= v}, each step 32 lanes probing evenly
    spaced keys and the ballot's count narrowing the range."""
    while b - a > 32:
        step = (b - a + 31) >> 5
        c = sum(a + ln * step < b and keys[a + ln * step] <= v
                for ln in range(32))
        if c == 0:
            return a
        a, b = a + (c - 1) * step + 1, min(b, a + c * step)
    return a + sum(a + ln < b and keys[a + ln] <= v for ln in range(32))


def _tile_map(keys, total, t0):
    """One block's forward-filled entry map: the warp's searches for the
    tile's entries [lo, hi), the last entry of each key marking its slot,
    slot 0 the governing entry lo - 1, then the max-scan (each thread's 16
    slots folded, the thread maxima scanned exclusively)."""
    lo = _count_le(keys, 0, total, t0)
    hb = min(total, lo + TILE)
    hi = _count_le(keys, lo, hb, t0 + TILE - 1)
    if hi == hb and hb < total:
        hi = _count_le(keys, hb, total, t0 + TILE - 1)
    ent = torch.full((TILE,), -1, dtype=torch.long)
    ent[0] = lo - 1
    k = torch.tensor(keys[lo:hi], dtype=torch.long)
    j = torch.arange(lo, hi)
    last = torch.ones_like(k, dtype=torch.bool)
    last[:-1] = k[1:] != k[:-1]
    s = k - t0
    ok = last & (s > 0) & (s < TILE)
    ent[s[ok]] = j[ok]
    v = ent.view(NT, SPT)
    run = torch.cummax(v, dim=1).values
    ex = torch.cat([torch.tensor([-1]),
                    torch.cummax(run[:, -1], 0).values[:-1]])
    return torch.maximum(run, ex[:, None]).reshape(-1)


def tiled_fill(keys, streams, totals, n_out, inits):
    """The kernel's filled streams (B, n_out) int64, tile by tile."""
    bsz = keys.shape[0]
    out = [torch.empty((bsz, n_out), dtype=torch.long) for _ in streams]
    for r in range(bsz):
        row = keys[r].tolist()
        total = max(0, min(int(totals[r]), len(row)))
        for t0 in range(0, n_out, TILE):
            ent = _tile_map(row, total, t0)[: min(TILE, n_out - t0)]
            for o, s, ini in zip(out, streams, inits):
                vals = s[r].long()[ent.clamp(min=0)]
                o[r, t0: t0 + len(ent)] = torch.where(ent >= 0, vals, ini)
    return out


def _spans(addr, n, esize):
    """store_tile's split of n elements at byte address addr: the ragged
    head, the 16-byte vectors, the tail."""
    v = 16 // esize
    head = min(((16 - addr % 16) % 16) // esize, n)
    nvec = (n - head) // v
    return head, [head + i * v for i in range(nvec)], head + nvec * v


def _rgb_words(px):
    """GetRgb.words: the rgb words of six packed pixels (uint32 values)."""
    return [(px[0] & 0xFFFFFF) | ((px[1] << 24) & 0xFFFFFFFF),
            ((px[1] >> 8) & 0xFFFF) | ((px[2] << 16) & 0xFFFFFFFF),
            ((px[2] >> 16) & 0xFF) | ((px[3] << 8) & 0xFFFFFFFF),
            (px[4] & 0xFFFFFF) | ((px[5] << 24) & 0xFFFFFFFF),
            (px[5] >> 8) & 0xFFFF]


def tiled_dec3(filled, npx, n_out):
    """EPI_DEC3 as the kernel stores it: each tile's words through
    store_tile at the row's own alignment (rows of n_out * 3 / 4 words from
    a 16-byte aligned base), a vector from the six pixels it touches and a
    funnel shift, a ragged word from three."""
    bsz = filled.shape[0]
    units = n_out * 3 // 4
    out = np.zeros((bsz, units), np.uint32)
    for r in range(bsz):
        for t0 in range(0, n_out, TILE):
            u0 = t0 // 4 * 3
            n = min(TILE // 4 * 3, units - u0)
            lim = max(0, min(TILE, int(npx[r]) - t0))
            tile = filled[r, t0: t0 + TILE].tolist()

            def pixels(q, count):
                return [tile[q + k] & 0xFFFFFFFF if k < count and q + k < lim
                        else 0 for k in range(6)]

            def word(e, count, c):
                q = 4 * e // 3
                sh = 8 * (4 * e - 3 * q)
                w = _rgb_words(pixels(q, count))
                return ((w[c] | (w[c + 1] << 32)) >> sh) & 0xFFFFFFFF

            head, vecs, tail = _spans(4 * (r * units + u0), n, 4)
            for e in list(range(head)) + list(range(tail, n)):
                out[r, u0 + e] = word(e, 3, 0)
            for e in vecs:
                for c in range(4):
                    out[r, u0 + e + c] = word(e, 6, c)
    return torch.from_numpy(out.view(np.int32))


def _model_case(name):
    """(keys, three payload streams, totals, n_out, npx) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def rows(ks, n_out):
        mc = max(len(k) for k in ks) + 3
        keys = np.full((len(ks), mc), 2**31 - 1, np.int32)
        for r, k in enumerate(ks):
            keys[r, : len(k)] = k
            keys[r, len(k):] = rng.integers(-5, n_out, mc - len(k))  # junk
        return keys, np.array([len(k) for k in ks], np.int32)

    def sorted_keys(n, hi, lo=0):
        return np.sort(rng.choice(np.arange(lo, hi), n, replace=False))

    n_out = 3 * TILE
    if name == "entry on a tile's first slot":
        ks = [np.concatenate([[0, 5, TILE, TILE + 1], sorted_keys(50, 2 * TILE,
                                                             TILE + 2),
                              [2 * TILE]]),
              np.array([TILE, 2 * TILE, 2 * TILE + 3])]
    elif name == "a tile with no entry":
        ks = [np.array([0, 10, 2 * TILE + 100, 2 * TILE + 101]),
              np.array([3, TILE - 1])]
    elif name == "a tile with TILE entries":
        ks = [np.arange(2 * TILE), np.concatenate([[0], sorted_keys(
            TILE - 1, TILE, 1), np.arange(TILE, 3 * TILE, 2)])]
    elif name == "totals of 0":
        ks = [np.zeros(0, np.int64), sorted_keys(300, n_out)]
    elif name == "rows of different totals":
        ks = [sorted_keys(n, n_out) for n in (1, 40, 2000, 9000)]
    elif name == "n_out not a multiple of TILE":
        n_out = 2 * TILE + 12
        ks = [sorted_keys(700, n_out + 50), sorted_keys(3, n_out)]
    else:  # EPI_DEC3 words across a tile edge, rows off 16-byte boundaries
        n_out = TILE + 4
        ks = [np.concatenate([sorted_keys(30, TILE - 2), [TILE - 2, TILE - 1,
                                                           TILE, TILE + 2]])
              for _ in range(3)]
    keys, totals = rows(ks, n_out)
    pays = [rng.integers(-2**31, 2**31, keys.shape, dtype=np.int64)
            .astype(np.int32) for _ in range(3)]
    npx = np.array([n_out - 7 * r for r in range(len(ks))], np.int32)
    return (torch.from_numpy(keys), [torch.from_numpy(p) for p in pays],
            torch.from_numpy(totals), n_out, torch.from_numpy(npx))


_MODEL_CASES = ["entry on a tile's first slot", "a tile with no entry",
                "a tile with TILE entries", "totals of 0",
                "rows of different totals", "n_out not a multiple of TILE",
                "EPI_DEC3 words across a tile edge"]
_MODEL_EPILOGUES = {
    "fill": None,
    "decode 4ch": decode_v2._epilogue(3, 4),
    "decode 3ch": decode_v2._epilogue(3, 3),
    "decode mono 1ch": decode_v2._epilogue(1, 1),
    "decode mono 2ch": decode_v2._epilogue(1, 2),
    "encode color": encode_v2._emit_epilogue(3),
    "encode mono": encode_v2._emit_epilogue(1),
    "encode qoi": encode_v2._compat_epilogue(),
    "decode gray to 4ch": decode_v2._epilogue(1, 4),
    "decode gray to 3ch": decode_v2._epilogue(1, 3),
    "decode colour to 1ch": decode_v2._epilogue(3, 1),
    "decode colour to 2ch": decode_v2._epilogue(3, 2),
}


def _gray_xf(f):
    """The kernel's gray word transform (xf<XF_GRAY>): byte 0 to R, G and B,
    byte 3 kept."""
    return (f & 255) * 0x010101 | (f & 0xFF000000)


@pytest.mark.parametrize("epi_name", list(_MODEL_EPILOGUES))
@pytest.mark.parametrize("case", _MODEL_CASES)
def test_tiled_engine_model_matches_plain(case, epi_name):
    """csrc/engine.cu's tiling modelled in PyTorch (search, entry map,
    max-scan fill, store_tile's vectors) against the plain versions: the
    filled streams against _fill_plain, each epilogue's output against
    place_emit on the CPU (the RGB words, of colour or of gray, as the
    kernel builds them). Integer outputs: exact."""
    keys, pays, totals, n_out, npx = _model_case(case)
    epi = _MODEL_EPILOGUES[epi_name]
    if epi is None:
        inits = (-7, 3, 11, -1)
        want = engine.place_fill(keys, pays, totals, n_out, inits,
                                 fill_keys=True)
        got = tiled_fill(keys, pays + [keys], totals, n_out, inits)
        for g, w in zip(got, want):
            assert torch.equal(g, w.long())
        return
    keyed = epi.kind in (engine.EPI_ENC3, engine.EPI_ENC1, engine.EPI_ENCQ)
    if keyed:
        payloads, inits = pays[:2], encode_v2._emit_inits()
        # chunk totals inside the output, past it and at 0; trail; emit_tail
        rows = torch.arange(len(npx))
        ct = torch.tensor([n_out - 30, n_out + 5, 0, n_out // 2])[rows]
        scal = torch.stack([ct, rows % 2, ((rows + 1) % 3 != 0).long()],
                           dim=-1).to(torch.int32)
    else:
        payloads, inits, scal = pays[:1], (_INIT,), npx[:, None]
    want = engine.place_emit(keys, payloads, totals, scal, n_out, inits, epi)
    streams = payloads + ([keys] if keyed else [])
    filled = tiled_fill(keys, streams, totals, n_out, inits)
    if epi.kind == engine.EPI_DEC3:
        got = tiled_dec3(filled[0], npx, n_out)
    elif epi.kind == engine.EPI_GRAY3:
        got = tiled_dec3(_gray_xf(filled[0]), npx, n_out)
    else:
        got = epi.plain(filled, torch.arange(n_out)[None, :], scal.long())
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
