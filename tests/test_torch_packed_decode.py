"""Segment-packed decode of icon-class images in the port.

K1's segment mode: the port's plain version (CPU) against the Pallas kernel
in interpret mode (a subprocess: the flag must be set before seqoia_tpu
loads), one 32768-byte row per mode. ``decode_stream_packed``: against the
native oracle and ``seqoia_tpu.decode`` per image, over the cases of
tests/test_packed_decode.py (dummy segments, forced channels, segments of
4096 and 8192 bytes, mono at 1 and 2 channels, the REF row flag). Inputs
are made from a seed with numpy; every comparison is exact (tolerance 0).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import seqoia_tpu as sq
from seqoia_tpu import native, spec
from seqoia_tpu_torch import convert
from seqoia_tpu_torch.codec import decode_v2
from seqoia_tpu_torch.ops import frontend
from seqoia_tpu_torch.utils import corpus

# one thread per process: the suite runs several workers, and the plain
# versions' many small tensor ops only contend when each takes every core
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64 * 64  # seg_px: every image decodes to exactly 4096 pixels
KINDS = ["palette", "runs", "luma", "solid", "alpha_churn"]

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
    seg, seg_px = int(inp[name + "/seg"]), int(inp[name + "/seg_px"])
    keys, pays, totals, has_ref = pallas_frontend.decode_front_compact(
        jnp.asarray(data), jnp.asarray(inp[name + "/slens"]),
        (data.shape[1] // seg) * seg_px, mode=str(inp[name + "/mode"]),
        rows=256, seg=seg, seg_px=seg_px)
    out[name + "/keys"] = np.asarray(keys)
    out[name + "/pays"] = np.asarray(pays[0])
    out[name + "/totals"] = np.asarray(totals)
    out[name + "/has_ref"] = np.asarray(has_ref)
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def gen(rng, kind, stride, n=N):
    """The icon-like content of tests/test_packed_decode.py: run-heavy, so
    that a 64x64 stream fits its segment."""
    if kind == "palette":
        pal = rng.integers(0, 256, (5, stride), dtype=np.uint8)
        runs = rng.integers(4, 50, 400)
        idx = np.repeat(rng.integers(0, 5, 400), runs)[:n]
        idx = np.pad(idx, (0, n - len(idx)), mode="edge")
        return pal[idx].ravel()
    if kind == "runs":
        vals = rng.integers(0, 5, (14, stride), dtype=np.uint8) * 40
        pix = np.repeat(vals, rng.integers(100, 700, 14), axis=0)[:n]
        pix = np.pad(pix, ((0, n - len(pix)), (0, 0)), mode="edge")
        return pix.ravel()
    if kind == "solid":
        return np.tile(rng.integers(0, 256, stride, dtype=np.uint8), n)
    steps = rng.integers(2, 8, 1200) if kind == "luma" else \
        rng.integers(3, 9, 900)
    m = len(steps)
    if kind == "luma":
        dg = rng.integers(-16, 16, (m, 1))
        d = np.concatenate([dg + rng.integers(-4, 5, (m, 1))
                            for _ in range(stride)], axis=1)
        if stride in (2, 4):
            d[:, -1] = rng.integers(-8, 8, m)
        lev = np.cumsum(d, 0) + 120
    else:  # alpha_churn: LUMA (+ ALPHA modifier) trains
        d = rng.integers(-6, 7, (m, stride))
        if stride in (2, 4):
            d[:, -1] = rng.integers(-10, 11, m)
        lev = np.cumsum(d, 0) + 128
    pix = np.repeat(lev, steps, axis=0)[:n]
    pix = np.pad(pix, ((0, n - len(pix)), (0, 0)), mode="edge")
    return (pix % 256).astype(np.uint8).ravel()


def _stride(ch):
    return (1 if ch < 3 else 3) + (1 - (ch & 1))


def pack_rows(streams, seg, rows=None):
    """Streams -> ((rows, 32768) uint8, (rows, 32768 // seg) int32 segment
    lengths); segments past the last stream stay empty (length 0)."""
    k = 32768 // seg
    b = rows or -(-len(streams) // k)
    data = np.zeros((b, k * seg), np.uint8)
    slens = np.zeros((b, k), np.int32)
    for j, s in enumerate(streams):
        assert len(s) <= seg, ("test content must fit the segment", len(s))
        r, c = divmod(j, k)
        data[r, c * seg: c * seg + len(s)] = np.frombuffer(s, np.uint8)
        slens[r, c] = len(s) - spec.PADDING_SIZE
    return data, slens


def _evil():
    """A header and one REF op."""
    return (spec.pack_header(spec.SqoaDesc(64, 64, 4, 0, 0))
            + bytes([0x20, 0x01]) + spec.PADDING)


def _k1_cases():
    rng = np.random.default_rng(7)

    def streams(ch, kinds, w=64):
        return [native.encode(gen(rng, k, _stride(ch), w * 64), w, 64, ch, 0, 0)
                for k in kinds]

    cases = {}
    # RGBA icons, 7 images and one empty segment
    data, slens = pack_rows(streams(4, KINDS + ["luma", "alpha_churn"]), 4096)
    cases["alpha_4096"] = dict(data=data, slens=slens, mode="alpha", seg=4096,
                               seg_px=N)
    # RGB icons in 8192-byte segments; the third image is 72x64, so its last
    # ops pass seg_px and are dropped
    rgb = streams(3, ["palette", "luma"]) + streams(3, ["runs"], w=72) \
        + streams(3, ["alpha_churn"])
    data, slens = pack_rows(rgb, 8192)
    cases["noalpha_8192"] = dict(data=data, slens=slens, mode="noalpha",
                                 seg=8192, seg_px=N)
    # gray and gray+alpha, and a REF op that flags the row
    mono = streams(1, KINDS[:4]) + streams(2, ["alpha_churn", "luma"]) \
        + [_evil()]
    data, slens = pack_rows(mono, 4096)
    cases["mono_4096"] = dict(data=data, slens=slens, mode="mono", seg=4096,
                              seg_px=N)
    return cases


K1_CASES = _k1_cases()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k1seg")
    arrays = {"names": np.array(list(K1_CASES))}
    for name, c in K1_CASES.items():
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


@pytest.mark.parametrize("name", list(K1_CASES))
def test_front_segment_mode_matches_pallas(name, pallas_out):
    c = K1_CASES[name]
    k = 32768 // c["seg"]
    keys, pays, totals, has_ref = frontend.decode_front_compact(
        torch.from_numpy(c["data"]), torch.from_numpy(c["slens"]),
        k * c["seg_px"], mode=c["mode"], seg=c["seg"], seg_px=c["seg_px"])
    want = convert.decode_front(
        pallas_out[name + "/keys"], [pallas_out[name + "/pays"]],
        pallas_out[name + "/totals"], pallas_out[name + "/has_ref"])
    assert torch.equal(totals, want[2]), (totals, want[2])
    assert torch.equal(has_ref, want[3]), (has_ref, want[3])
    assert has_ref.tolist() == [int(name == "mono_4096")]
    t = int(totals[0])
    assert t > 0
    assert torch.equal(keys[0, :t], want[0][0, :t])
    assert torch.equal(pays[0, :t], want[1][0, :t])


def test_front_segment_mode_drops_ops_past_seg_px():
    """The 72x64 image of the noalpha case has more pixels than seg_px: its
    segment's keys stop below the next image's first pixel."""
    c = K1_CASES["noalpha_8192"]
    keys, _, totals, _ = frontend.decode_front_compact(
        torch.from_numpy(c["data"]), torch.from_numpy(c["slens"]), 4 * N,
        mode="noalpha", seg=8192, seg_px=N)
    k = keys[0, : int(totals[0])]
    assert bool((k[1:] > k[:-1]).all())
    third = k[(k >= 2 * N) & (k < 3 * N)]
    full = frontend.decode_front_compact(
        torch.from_numpy(c["data"][:, 2 * 8192: 3 * 8192].copy()),
        torch.from_numpy(c["slens"][:, 2].copy()), 72 * 64, mode="noalpha")
    assert 0 < len(third) < int(full[2][0])


def test_front_segment_mode_rejects_bad_arguments():
    data = torch.zeros((1, 32768), dtype=torch.uint8)
    slens = torch.zeros((1, 8), dtype=torch.int32)
    ok = dict(mode="alpha", seg=4096, seg_px=N)
    frontend.decode_front_compact(data, slens, 8 * N, **ok)
    with pytest.raises(ValueError, match="n_max"):
        frontend.decode_front_compact(data, slens, 4 * N, **ok)
    with pytest.raises(ValueError, match="chunks_len"):
        frontend.decode_front_compact(data, slens[:, :4], 8 * N, **ok)
    for seg in (3000, 64, 65536):
        with pytest.raises(ValueError, match="power of two"):
            frontend.decode_front_compact(data, slens, 8 * N, mode="alpha",
                                          seg=seg, seg_px=N)


def _check_packed(images, ch, seg, out_ch, jax_too=True):
    colch = 1 if ch < 3 else 3
    streams = [native.encode(p, 64, 64, ch, 0, 0) for p in images]
    data, slens = pack_rows(streams, seg)
    out, has_ref = decode_v2.decode_stream_packed(
        torch.from_numpy(data), torch.from_numpy(slens), colch=colch,
        out_ch=out_ch, seg=seg, seg_px=N, src_alpha=(ch % 2 == 0))
    assert not bool(has_ref.any())
    ob = out.numpy().view(np.uint8).reshape(data.shape[0], -1)
    k = 32768 // seg
    for j, s in enumerate(streams):
        r, c = divmod(j, k)
        got = ob[r, c * N * out_ch: (c + 1) * N * out_ch]
        exp, _ = native.decode(s, out_ch)
        assert np.array_equal(got, exp), (ch, seg, out_ch, j)
        if jax_too and j < 2:
            theirs, _ = sq.decode(s, out_ch)
            assert np.array_equal(got, np.asarray(theirs)), (ch, out_ch, j)


@pytest.mark.parametrize("ch,n_img,seg,out_ch", [
    (4, 11, 4096, 4),   # alpha mode; a second row padded with empty segments
    (4, 5, 4096, 3),    # the same class forced to 3 channels
    (3, 9, 8192, 3),    # noalpha mode, 8192-byte segments
    (3, 3, 8192, 4),    # forced to 4 channels
    (1, 10, 4096, 1),   # gray
    (2, 6, 4096, 2),    # gray + alpha
    (4, 3, 4096, 1),    # color forced to gray (K2's colour-to-gray epilogue)
    (1, 3, 4096, 4),    # gray forced to RGBA
])
def test_decode_stream_packed(ch, n_img, seg, out_ch):
    rng = np.random.default_rng(100 * ch + n_img)
    kinds = ["alpha_churn"] * n_img if ch == 2 else \
        [KINDS[i % (4 if ch == 1 else 5)] for i in range(n_img)]
    _check_packed([gen(rng, k, _stride(ch)) for k in kinds], ch, seg, out_ch)


def test_decode_stream_packed_flags_the_ref_row():
    """A REF op flags its whole packed row; the sibling row stays clean."""
    rng = np.random.default_rng(3)
    good = [native.encode(gen(rng, "palette", 4), 64, 64, 4, 0, 0)
            for _ in range(9)]
    data, slens = pack_rows(good[:8] + [_evil(), good[8]], 4096)
    out, has_ref = decode_v2.decode_stream_packed(
        torch.from_numpy(data), torch.from_numpy(slens), colch=3, out_ch=4,
        seg=4096, seg_px=N, src_alpha=True)
    assert has_ref.tolist() == [False, True]
    ob = out.numpy().view(np.uint8).reshape(2, -1)
    for j, s in enumerate(good[:8]):
        assert np.array_equal(ob[0, j * N * 4: (j + 1) * N * 4],
                              native.decode(s, 4)[0])


# --- the single-launch segment mode's design (csrc/frontend.cu, k > 1) -----

from test_torch_frontend import (HALO, HDR1, I32MAX, IDENT6, IPT, NT, PACK,  # noqa: E402
                                 TILE, _elem, _tok, compose6, end_peek, step6,
                                 val_op)

SEG_START = 4  # the start flag of a segmented channel element


def seg_chan_op(left, right):
    """SChanOp on (val, flg, npix): right wins where it starts a segment."""
    if right[1] & SEG_START:
        return right
    v, f = val_op(left[:2], right[:2])
    return v, f | (left[1] & SEG_START), min(left[2] + right[2], I32MAX)


def seg_map_op(left, right):
    """SegMap on (flag, map)."""
    return right if right[0] else (left[0], compose6(left[1], right[1]))


def _fold_back(status, tile, op, ident, pack, unpack, rng, p_prefix):
    """tile_prefix: predecessors in random published states (aggregate or
    inclusive prefix), each through its status word, folded with the
    farthest on the left until an inclusive prefix; a tile published only
    as an aggregate (None for its prefix) is read as one."""
    vals = []
    for k in range(tile - 1, -1, -1):
        agg, incl = status[k]
        prefix = incl is not None and (k == 0 or rng.random() < p_prefix)
        word = pack(incl if prefix else agg)
        assert 0 <= word < 1 << 62
        vals.append(unpack(word))
        if prefix:
            break
    ex = ident
    for v in reversed(vals):
        ex = op(ex, v)
    return ex


def _excl(vals, op, ident):
    out, run = [], ident
    for v in vals:
        out.append(run)
        run = op(run, v)
    return out, run


FOLDS = {
    "map": (compose6, IDENT6, *PACK["map"]),
    "val": (val_op, (0, 0), *PACK["val"]),
    "npix": (lambda a, b: min(a + b, I32MAX), 0, lambda x: x,
             lambda w: w & 0x7FFFFFFF),
    "rank": (lambda a, b: a + b, 0, lambda x: x, lambda w: w & 0xFFFFFFFF),
}


def lookback_front_seg(data, slens, mode, seg, seg_px, seed=0, p_prefix=0.2):
    """csrc/frontend.cu's segment mode in Python, tile by tile in the
    counter's order: dead tiles, the live bytes staged by 16-byte vectors,
    the segmented map scan (a long segment's look-back over its tiles),
    the op list (and in mode noalpha the alpha peek after each segment's
    last op) from each thread's state-0 bytes, dealt out as equal runs, the segmented channel fold and the
    long segment's (val, flg) and pixel-count look-backs, keys and payloads
    in place with the ops past seg_px dropped, and the kept ops ranked by
    a look-back over the packed row. Returns (keys, payloads, totals,
    has_ref) as numpy arrays, the entries past totals 0."""
    rng = np.random.default_rng(seed)
    bsz, m = data.shape
    k = m // seg
    nt = -(-m // TILE)
    keys = np.zeros((bsz, m), np.int64)
    pays = np.zeros((bsz, m), np.int64)
    totals = np.zeros(bsz, np.int64)
    has_ref = np.zeros(bsz, np.int64)

    def fold(kind, status, tile):
        return _fold_back(status, tile, *FOLDS[kind], rng, p_prefix)

    for row in range(bsz):
        live = [min(max(int(c), 0), seg) for c in slens[row]]
        st_rank, st_seg = {}, {}  # st_seg: {segment: {kind: status}}
        for tile in range(nt):
            base = tile * TILE
            j0 = base // seg
            tis = (base % seg) // TILE if seg > TILE else -1
            if tis >= 0:
                alive = live[j0] > max(base % seg, HDR1)
            else:
                nseg = min(TILE, m - base) // seg
                alive = any(live[j0 + t] > HDR1 for t in range(nseg))
            if not alive:
                if tile == nt - 1:
                    totals[row] = 0 if tile == 0 else fold("rank", st_rank,
                                                           tile)
                st_rank[tile] = (0, 0 if tile == 0 else None)
                continue
            t = np.zeros(TILE + 16, np.int64)
            for v in range(TILE // 16 + 1):
                p = base + 16 * v
                if p < m and p % seg < live[p // seg] + HALO:
                    t[16 * v: 16 * v + 16] = data[row, p: p + 16]

            def masked(i):  # the staged bytes with those past i's segment 0
                u = t.copy()
                end = i - (base + i) % seg + seg
                u[max(end, 0):] = 0
                return u
            lens, atts = [], []
            views = {}
            for i in range(TILE):
                end = i - (base + i) % seg + seg
                u = views.setdefault(end, masked(i))
                n_, a_ = _tok(u, i, mode)
                lens.append(1 if (base + i) % seg < HDR1 else n_)
                atts.append(a_)
            maps = []
            for th in range(NT):
                mp = IDENT6
                for j in range(IPT):
                    mp = step6(mp, lens[th * IPT + j] - 1)
                maps.append(((base + th * IPT) % seg == 0, mp))
            ex_map, agg_map = _excl(maps, seg_map_op, (False, IDENT6))
            st_s = st_seg.setdefault(j0, {"map": {}, "val": {}, "npix": {}})
            pm = IDENT6
            if tis >= 0:
                pm = IDENT6 if tis == 0 else fold("map", st_s["map"], tis)
                st_s["map"][tis] = (agg_map[1], compose6(pm, agg_map[1]))

            ops = []  # the tile's ops in order: their staged bytes
            for th in range(NT):
                p0 = base + th * IPT
                if maps[th][0]:
                    state = 0
                elif ex_map[th][0]:
                    state = ex_map[th][1] & 7
                else:
                    state = (ex_map[th][1] >> (3 * (pm & 7))) & 7
                lo = min(max(HDR1 - p0 % seg, 0), IPT)
                hi = min(max(live[p0 // seg] - p0 % seg, 0), IPT) \
                    if p0 < m else 0
                tz = 0
                for j in range(IPT):
                    tz |= (state == 0) << j
                    state = lens[th * IPT + j] - 1 if state == 0 else state - 1
                tm = tz & ((1 << hi) - 1) & ~((1 << lo) - 1)
                ops += [th * IPT + j for j in range(IPT) if tm >> j & 1]
                c = int(slens[row][p0 // seg]) if p0 < m else 0
                if (mode == "noalpha" and hi > 0 and p0 % seg + hi == c
                        and c > HDR1):
                    e = end_peek(tz, hi, state)
                    b = int(t[th * IPT + e])
                    has_ref[row] |= p0 % seg + e < seg and 0x60 <= b < 0x80
            elems, prev = [], -1 if tis <= 0 else 0
            for i in ops:
                sg = (base + i) // seg - j0
                (v, f, _, npix), foreign = _elem(views[
                    i - (base + i) % seg + seg], i, atts[i], mode)
                elems.append((v, f | (SEG_START if sg != prev else 0), npix,
                              sg))
                prev = sg
                has_ref[row] |= foreign
            per = -(-len(ops) // NT)
            runs = [range(min(th * per, len(ops)),
                          min(th * per + per, len(ops))) for th in range(NT)]
            accs = []
            for rn in runs:
                acc = (0, 0, 0)
                for q in rn:
                    acc = seg_chan_op(acc, elems[q][:3])
                accs.append(acc)
            ex_c, agg = _excl(accs, seg_chan_op, (0, 0, 0))
            pre = (0, 0, 0)
            if tis >= 0:
                pv = (0, 0) if tis == 0 else fold("val", st_s["val"], tis)
                pn = 0 if tis == 0 else fold("npix", st_s["npix"], tis)
                st_s["val"][tis] = ((agg[0], agg[1] & 3),
                                    val_op(pv, (agg[0], agg[1] & 3)))
                st_s["npix"][tis] = (agg[2], min(pn + agg[2], I32MAX))
                if tis > 0:
                    pre = (*pv, pn)
            out = []  # per op: global key or -1, payload
            kept = []
            for th, rn in enumerate(runs):
                run = seg_chan_op(pre, ex_c[th])
                kc = 0
                for q in rn:
                    v, f, npix, sg = elems[q]
                    if f & SEG_START:
                        run = (0, 0, 0)
                    key = run[2]
                    run = seg_chan_op(run, (v, f, npix))
                    a = (run[0] >> 24) & 255
                    a = a if run[1] & 2 else (a + 255) & 255
                    pay = (run[0] & 0xFFFFFF) | (a << 24)
                    keep = key < seg_px
                    out.append(((j0 + sg) * seg_px + key if keep else -1,
                                pay))
                    kc += keep
                kept.append(kc)
            n_kept = sum(kept)
            rank = 0 if tile == 0 else fold("rank", st_rank, tile)
            st_rank[tile] = (n_kept, rank + n_kept)
            r = rank
            for key, pay in out:
                if key >= 0:
                    keys[row, r], pays[row, r] = key, pay
                    r += 1
            if tile == nt - 1:
                totals[row] = rank + n_kept
    for row in range(bsz):
        keys[row, totals[row]:] = 0
        pays[row, totals[row]:] = 0
    return (keys.astype(np.int32), pays.astype(np.uint32).view(np.int32),
            totals.astype(np.int32), has_ref.astype(np.int32))


def _seg_model_cases():
    """{name: (data, slens, mode, seg)}: every seg from 128 to 32768, empty
    segments, images whose ops pass seg_px, streams ending mid-tile, and
    rows whose segments hold very different op counts."""
    rng = np.random.default_rng(21)
    modes = {4: "alpha", 3: "noalpha", 1: "mono", 2: "mono"}
    cases = {}
    for i, seg in enumerate([128 << e for e in range(9)]):
        ch = (4, 3, 1, 2)[i % 4]
        m = max(8192, 4 * seg)
        k = m // seg
        pool = {}
        for kind in ("solid", "runs", "palette", "luma", "alpha_churn",
                     "noise"):
            for w in (64, 72):  # 72x64: the ops past seg_px are dropped
                if kind == "noise":  # noise, then a solid half: long streams
                    px = gen(rng, "solid", _stride(ch), w * 64)
                    px[: len(px) // 2] = rng.integers(0, 256, len(px) // 2)
                else:
                    px = gen(rng, kind, _stride(ch), w * 64)
                s = native.encode(px, w, 64, ch, 0, 0)
                if len(s) <= seg:
                    pool[(kind, w)] = s
        by_len = sorted(pool.values(), key=len)
        streams = [by_len[rng.integers(len(by_len))] for _ in range(k)]
        streams[0] = by_len[-1]  # the longest: across tile edges
        streams[1] = b""  # an empty segment
        streams[2] = max((v for (_, w), v in pool.items() if w == 72),
                         key=len)
        data = np.zeros((1, m), np.uint8)
        slens = np.zeros((1, k), np.int32)
        for j, s in enumerate(streams):
            data[0, j * seg: j * seg + len(s)] = np.frombuffer(s, np.uint8)
            slens[0, j] = max(len(s) - spec.PADDING_SIZE, 0)
        cases[f"seg {seg} {modes[ch]}"] = (data, slens, modes[ch], seg)
    # a length past the stream: ops to the segment's end, operands past it 0
    data, slens, mode, seg = cases["seg 512 mono"]
    slens = slens.copy()
    slens[0, 3] = seg
    cases["seg 512 mono to the segment's end"] = (data, slens, mode, seg)
    # rows of one class: very different op counts side by side
    data, slens = pack_rows([native.encode(gen(rng, k_, 4), 64, 64, 4, 0, 0)
                             for k_ in ("solid", "luma", "solid", "alpha_churn",
                                        "runs", "luma", "solid")], 4096)
    cases["seg 4096 alpha mixed"] = (data, slens, "alpha", 4096)
    # RGB segments whose last op is followed by an alpha-range byte in the
    # marker (corpus.end_peek_segments), and the same row with only the
    # segments that must not flag
    for seg in (128, 8192):
        data, slens, quiet = corpus.end_peek_segments(seg, TILE)
        cases[f"seg {seg} noalpha end peek"] = (data, slens, "noalpha", seg)
        cases[f"seg {seg} noalpha no end peek"] = (data, quiet, "noalpha",
                                                   seg)
    return cases


SEG_MODEL_CASES = _seg_model_cases()


def test_segment_end_peek_cases_are_flagged():
    """The plain version flags each packed row of the end-peek cases, where
    a segment ends with the reference's peek on an alpha-range byte, and
    no row of the cases whose segments peek only one byte short of one or
    past their segment's end (where the next image's header starts)."""
    for seg in (128, 8192):
        for name, want in (("end peek", 1), ("no end peek", 0)):
            data, slens, mode, _ = SEG_MODEL_CASES[f"seg {seg} noalpha {name}"]
            k = data.shape[1] // seg
            ref = frontend.decode_front_plain_seg(
                torch.from_numpy(data), torch.from_numpy(slens), k * N, mode,
                seg, N)[3]
            assert ref.tolist() == [want] * data.shape[0]


@pytest.mark.parametrize("name", list(SEG_MODEL_CASES))
def test_segment_front_model_matches_plain(name):
    data, slens, mode, seg = SEG_MODEL_CASES[name]
    k = data.shape[1] // seg
    want = frontend.decode_front_plain_seg(
        torch.from_numpy(data), torch.from_numpy(slens), k * N, mode, seg, N)
    assert int(want[2][0]) > 0
    for seed, p_prefix in ((0, 0.2), (1, 0.9)):
        got = lookback_front_seg(data, slens, mode, seg, N, seed, p_prefix)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
