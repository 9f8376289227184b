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
    # shards with no change: the carried run's anchor is the last change
    cases["flat_shard_4096"] = dict(
        packed=np.full((2, 4096), 0x00102030, np.int32),
        nv=np.array([4096, 700], np.int32), colch=3,
        init_prev=np.full(2, 0x00102030, np.int32),
        lc0=np.array([-301, -512], np.int32))
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


# --- the single-pass kernel's design (csrc/encode_front.cu) ----------------

NT, IPT = 256, 16  # threads a block, pixels a thread
TILE = NT * IPT    # pixels a tile
LC_BIAS = 513      # a biased last change is >= 1; 0 is none
ST_AGG, ST_PREFIX = 1, 2


def _wrap8(x):
    return ((x + 128) & 255) - 128


def _op_meta(cur, prev, colch):
    """op_meta on arrays: (meta word without pending, op length)."""
    ch = [(cur >> (8 * k)) & 255 for k in range(4)]
    ph = [(prev >> (8 * k)) & 255 for k in range(4)]
    vg, va = _wrap8(ch[1] - ph[1]), _wrap8(ch[3] - ph[3])
    if colch == 3:
        vg_r = _wrap8(_wrap8(ch[0] - ph[0]) - vg)
        vg_b = _wrap8(_wrap8(ch[2] - ph[2]) - vg)
        luma = ((vg_r >= -8) & (vg_r <= 7) & (vg >= -32) & (vg <= 31)
                & (vg_b >= -8) & (vg_b <= 7) & (va >= -16) & (va <= 15))
        cls = np.where(luma, 0, 1)
        op_len = np.where(luma, 2, 4) + (va != 0)
    else:
        vg_r = vg_b = np.zeros_like(vg)
        luma = (vg >= -7) & (vg <= 8) & (va >= -16) & (va <= 15)
        cls = np.where(va != 0, 2, np.where(luma, 0, 1))
        op_len = np.where(va != 0, 3, np.where(luma, 1, 2))
    meta = ((cls << 9) | (((vg + 32) & 63) << 12) | (((vg_r + 8) & 15) << 18)
            | (((vg_b + 8) & 15) << 22) | (((va + 16) & 31) << 26)
            | ((va != 0).astype(np.int64) << 31))
    return meta, op_len


def _pack_sums(cnt, nbytes):
    """SumC's status word: bytes mod 2**32 in bits 0-31, entries in 32-61."""
    assert 0 <= cnt < 1 << 30
    return (nbytes & 0xFFFFFFFF) | (cnt << 32)


def _unpack_sums(w):
    return (w >> 32) & 0x3FFFFFFF, w & 0xFFFFFFFF


def _lastc_lookback(status, tile, rng, p_prefix):
    """lastc_prefix: the nearest predecessor whose word holds a change or
    an inclusive prefix. A tile with a change is only ever seen with its
    prefix (it publishes it first); one without, in a random state."""
    for k in range(tile - 1, -1, -1):
        agg, incl = status[k]
        if agg != 0:
            return agg
        if rng.random() < p_prefix:
            return incl  # an inclusive prefix, perhaps 0 (none)
    return 0


def _sums_lookback(status, tile, rng, p_prefix):
    """tile_prefix over SumC: predecessors in random published states
    (aggregate or inclusive prefix), each through its status word, summed
    until an inclusive prefix."""
    cnt = nbytes = 0
    for k in range(tile - 1, -1, -1):
        agg, incl = status[k]
        prefix = k == 0 or rng.random() < p_prefix
        c, b = _unpack_sums(_pack_sums(*(incl if prefix else agg)))
        cnt, nbytes = cnt + c, (nbytes + b) & 0xFFFFFFFF
        if prefix:
            break
    return cnt, nbytes


def lookback_encode_front(packed, n_valid, colch, init_prev, lc0, seed=0,
                          p_prefix=0.1):
    """csrc/encode_front.cu in numpy, tile by tile in the counter's order:
    each thread's change bits over its 16 pixels, the block max-scan of the
    threads' last changes, the last-change look-back, each thread's walk
    from the last change before its first pixel, the (entries, bytes) block
    scan and look-back, the emitting pixels at their ranks, and the row's
    scalars from the tile of its last valid pixel. Returns the outputs of
    encode_front_plain as numpy arrays (entries past the totals 0)."""
    rng = np.random.default_rng(seed)
    packed = packed.astype(np.int64)
    bsz, n = packed.shape
    nt = -(-n // TILE)
    keys, curs, metas = (np.zeros((bsz, n), np.int64) for _ in range(3))
    scal = np.zeros((3, bsz), np.int64)
    for row in range(bsz):
        nv = int(n_valid[row])
        st_lc, st_sum = {}, {}
        for tile in range(nt):
            base = tile * TILE
            if tile > 0 and base >= nv:
                break
            cnt = min(TILE, max(nv - base, 0))
            t = np.zeros(TILE, np.int64)
            t[:cnt] = packed[row, base: base + cnt]
            prev_px = packed[row, base - 1] if base else int(init_prev[row])
            cur = t.reshape(NT, IPT)
            prev = np.concatenate([[prev_px], t[:-1]]).reshape(NT, IPT)
            local = np.arange(TILE).reshape(NT, IPT)
            change = (cur != prev) & (local < cnt)
            last = np.where(change, local, -1).max(axis=1)
            ex_l = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
            agg_l = int(last.max())
            agg_w = base + agg_l + LC_BIAS if agg_l >= 0 else 0
            ex_w = 0 if tile == 0 else _lastc_lookback(st_lc, tile, rng,
                                                       p_prefix)
            st_lc[tile] = (agg_w, agg_w or ex_w)
            lc_in = ex_w - LC_BIAS if ex_w else int(lc0[row])

            # each thread's walk from the last change before its first pixel
            lastc = np.where(ex_l >= 0, base + ex_l, lc_in)
            op_meta, op_len = _op_meta(cur, prev, colch)
            tl = np.zeros((NT, IPT), np.int64)
            meta = np.zeros((NT, IPT), np.int64)
            for j in range(IPT):
                g = base + local[:, j]
                ch = change[:, j]
                pending = np.where(ch, (g - 1 - lastc) & 511, 0)
                flush = np.where(pending > 0, (pending - 1) // 61 + 1, 0)
                lastc = np.where(ch, g, lastc)
                bigrun = ~ch & (local[:, j] < cnt) & ((g - lastc) & 511 == 0)
                tl[:, j] = np.where(ch, flush + op_len[:, j], bigrun)
                none = (7 << 9) | (32 << 12) | (8 << 18) | (8 << 22) | (16 << 26)
                meta[:, j] = np.where(ch, op_meta[:, j] | pending, none)
            t_cnt, t_bytes = (tl > 0).sum(axis=1), tl.sum(axis=1)
            ex_cnt = np.concatenate([[0], np.cumsum(t_cnt)[:-1]])
            ex_bytes = np.concatenate([[0], np.cumsum(t_bytes)[:-1]])
            agg = (int(t_cnt.sum()), int(t_bytes.sum()))
            pre = ((0, 0) if tile == 0 else
                   _sums_lookback(st_sum, tile, rng, p_prefix))
            st_sum[tile] = (agg, (pre[0] + agg[0], pre[1] + agg[1]))
            if tile == max(nv - 1, 0) // TILE:
                scal[:, row] = (pre[0] + agg[0],
                                (pre[1] + agg[1]) & 0xFFFFFFFF,
                                base + agg_l if agg_l >= 0 else lc_in)
            # the emitting pixels at their ranks
            for th in range(NT):
                r, b = pre[0] + ex_cnt[th], pre[1] + ex_bytes[th]
                for j in range(IPT):
                    if tl[th, j]:
                        keys[row, r] = b & 0xFFFFFFFF
                        curs[row, r] = cur[th, j]
                        metas[row, r] = meta[th, j]
                        r, b = r + 1, b + tl[th, j]

    def i32(x):
        return (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return i32(keys), i32(curs), i32(metas), i32(scal)


def _model_cases():
    """(packed (B, N), n_valid, colch, init_prev, lc0) per case."""
    rng = np.random.default_rng(11)
    init = encode_front.INIT_PACKED

    def noise(shape):
        return rng.integers(-2**31, 2**31, shape).astype(np.int32)

    def runs(n, mean):
        vals = noise(n)
        return np.repeat(vals, rng.integers(1, 2 * mean, n))[:n]

    def smooth(n):  # LUMA and small alpha steps
        d = rng.integers(-3, 4, (n, 4))
        d[rng.random(n) < 0.9, 3] = 0
        return (np.cumsum(d, 0) & 255).astype(np.uint8).view("<u4").view(
            np.int32).ravel()

    n3 = 3 * TILE + 100
    cases = {}
    # one color across several tiles: BIGRUNs only, and on a tile's edge
    flat = np.full((2, n3), 0x00403020, np.int32)
    cases["no change across tiles"] = (flat, [n3, n3], 3, [init, 0x00403020],
                                       [-1, -301])
    edge = np.repeat(noise(4), [TILE - 700, 1536, 1300, n3 - TILE - 2136])
    cases["bigruns across a tile edge"] = (edge[None], [n3], 3, [init], [-1])
    first = runs(n3, 40)
    for k in (1, 2, 3):  # a change on each tile's first pixel
        first[k * TILE] = first[k * TILE - 1] ^ 0x0101
    cases["a change on a tile's first pixel"] = (first[None], [n3], 3,
                                                 [init], [-1])
    nvs = [0, 1, 4095, 4096, 4097]
    px = np.stack([runs(TILE + 8, 3) for _ in nvs])
    cases["n_valid 0 1 4095 4096 4097"] = (px, nvs, 3, [init] * 5, [-1] * 5)
    carry = np.stack([np.r_[np.full(600, 7, np.int32), runs(TILE + 40, 5)]
                      for _ in range(3)])
    cases["carries run_in 0 1 511"] = (carry, [carry.shape[1]] * 3, 3,
                                       [7, 7, 9], [-1, -2, -512])
    gray = (np.stack([smooth(n3), runs(n3, 30)]) & ~0x00FF00FF)
    cases["colch 1"] = (gray, [n3, 2 * TILE + 5], 1, [init, 0x7F000000],
                        [-1, -40])
    cases["colch 3"] = (np.stack([smooth(n3), noise(n3)]), [n3, TILE - 1], 3,
                        [init, init], [-7, -1])
    mixed = np.stack([runs(n3, k) for k in (2, 50, 700)])
    cases["rows of different n_valid"] = (mixed, [n3, 5000, 12], 3,
                                          [init] * 3, [-1] * 3)
    return cases


MODEL_CASES = _model_cases()


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_lookback_encode_front_model_matches_plain(name):
    packed, nv, colch, ip, l0 = (np.asarray(x) for x in MODEL_CASES[name])
    args = [torch.from_numpy(packed.astype(np.int32)),
            torch.tensor(nv, dtype=torch.int32)]
    keys, (cur, meta), et, ct, lc = encode_front.encode_front_compact(
        *args, colch=int(colch), init_prev=torch.tensor(ip, dtype=torch.int32),
        lc0=torch.tensor(l0, dtype=torch.int32))
    want = [keys.numpy(), cur.numpy(), meta.numpy(),
            np.stack([et.numpy(), ct.numpy(), lc.numpy()])]
    for seed, p_prefix in ((0, 0.1), (1, 0.8)):
        got = lookback_encode_front(packed, nv, int(colch), ip, l0, seed,
                                    p_prefix)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_encode_front_keeps_the_carried_run_without_a_change():
    """A shard row with no change reports its carried run's anchor lc0 as
    its last change (as the Pallas kernel does), so the trailing run
    counts the carried pixels."""
    px = torch.full((2, 700), 0x00102030, dtype=torch.int32)
    keys, (_, meta), et, ct, lc = encode_front.encode_front_compact(
        px, torch.tensor([700, 0], dtype=torch.int32), colch=3,
        init_prev=torch.full((2,), 0x00102030, dtype=torch.int32),
        lc0=torch.tensor([-301, -5], dtype=torch.int32))
    assert lc.tolist() == [-301, -5]
    # 301 carried pixels: one BIGRUN, at pixel 211
    assert et.tolist() == [1, 0] and ct.tolist() == [1, 0]
    assert int(keys[0, 0]) == 0 and int(meta[0, 0]) >> 9 & 7 == 7


@pytest.mark.parametrize("bsz, n, words", [
    (1, 1, 2 * (2 + 1)), (1, 4096, 2 * (2 + 1)), (1, 4097, 2 * (4 + 1)),
    (32, 1048576, 2 * (2 * 32 * 256 + 1)),
    (1, 134217728, 2 * (2 * 32768 + 1)), (4, 33554432, 2 * (2 * 4 * 8192 + 1))])
def test_encode_front_scratch(bsz, n, words):
    assert encode_front.scratch_words(bsz, n) == words
