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
from seqoia_tpu_torch.utils import corpus

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


# --- the single-pass kernel's design (csrc/frontend.cu, k = 1) --------------

NT, IPT = 256, 16        # threads a block, bytes a thread
TILE = NT * IPT          # bytes a tile
HALO, HDR1 = 8, 15
I32MAX = 2**31 - 1
IDENT6 = sum(e << (3 * e) for e in range(6))


def compose6(left, right):
    """Apply left, then right (6 states, 3 bits each)."""
    return sum(((right >> (3 * ((left >> (3 * e)) & 7))) & 7) << (3 * e)
               for e in range(6))


def step6(m, c):
    """The kernel's SWAR step: compose6(m, the map of a byte whose token
    skips c more bytes)."""
    low = 0x9249
    nz = (m | (m >> 1) | (m >> 2)) & low
    return (m - nz) | ((low & ~nz) * c)


def val_op(left, right):
    """ChanOp's (val, flg) part: the segmented per-byte sum mod 256."""
    (lv, lf), (rv, rf) = left, right
    s = (((lv & 0x7F7F7F7F) + (rv & 0x7F7F7F7F)) ^ ((lv ^ rv) & 0x80808080))
    m = (0x00FFFFFF if rf & 1 else 0) | (0xFF000000 if rf & 2 else 0)
    return ((rv & m) | (s & ~m & 0xFFFFFFFF)), (lf | rf) & 3


def cnt_op(left, right):
    """ChanOp's (op count, pixel count) part; pixel counts saturate."""
    return left[0] + right[0], min(left[1] + right[1], I32MAX)


def chan_op(left, right):
    """ChanOp on whole (val, flg, cnt, npix) elements, as the kernel of the
    first port folds them."""
    (lv, lf, lc, ln), (rv, rf, rc, rn) = left, right
    s = (((lv & 0x7F7F7F7F) + (rv & 0x7F7F7F7F)) ^ ((lv ^ rv) & 0x80808080))
    m = (0x00FFFFFF if rf & 1 else 0) | (0xFF000000 if rf & 2 else 0)
    return ((rv & m) | (s & ~m & 0xFFFFFFFF), (lf | rf) & 3, lc + rc,
            min(ln + rn, I32MAX))


# the status words' packings: the map in 18 bits, (val, flg) in 34 and
# (cnt, npix) in 62, under the 2 state bits
PACK = {
    "map": (lambda x: x, lambda w: w),
    "val": (lambda x: x[0] | (x[1] << 32),
            lambda w: (w & 0xFFFFFFFF, (w >> 32) & 3)),
    "cnt": (lambda x: x[0] | (x[1] << 31),
            lambda w: (w & 0x7FFFFFFF, (w >> 31) & 0x7FFFFFFF)),
}
OPS = {"map": compose6, "val": val_op, "cnt": cnt_op}
IDENT = {"map": IDENT6, "val": (0, 0), "cnt": (0, 0)}


def _look_back(kind, status, tile, rng, p_prefix):
    """tile_prefix: windows of 32 predecessors, each read in a random
    published state from its status word, folded from the window's
    farthest lane down to the nearest inclusive prefix (the combines of the
    map and the channel sum do not commute), ex = op(window, ex)."""
    op, ident = OPS[kind], IDENT[kind]
    pack, unpack = PACK[kind]
    ex, j = ident, tile - 1
    while True:
        vals, stop = [], 31
        for lane in range(32):
            k = j - lane
            if k < 0:
                vals.append(ident)
                stop = min(stop, lane)
                break
            agg, incl = status[k]
            prefix = rng.random() < p_prefix
            word = pack(incl if prefix else agg)
            assert word < 1 << 62
            vals.append(unpack(word))
            if prefix:
                stop = lane
                break
        window = ident
        for v in reversed(vals[: stop + 1]):
            window = op(window, v)
        ex = op(window, ex)
        if stop < 31 or len(vals) < 32:
            return ex
        j -= 32


def _tok(t, i, mode):
    """The token length and alpha modifier delta at staged byte i."""
    b = int(t[i])
    luma, rgb, rgba = (b & 0xC0) == 0x80, b == 0xFE, b == 0xFF
    if mode == "mono":
        return 1 + rgb + 2 * rgba, 0
    if mode == "noalpha":
        return 1 + luma + 3 * rgb, 0
    n = 1 + luma + 3 * rgb + 4 * rgba
    nx = int(t[i + n])
    if 0x60 <= nx < 0x80:
        return n + 1, (nx & 31) - 16
    return n, 0


def end_peek(tz, hi, st):
    """end_peek: in the run of the thread whose bytes 0 .. hi - 1 end the
    stream (tz: its state-0 bytes, st: the state after it), the offset of
    the byte the reference peeks for an alpha modifier after the last op."""
    up = tz >> hi
    return hi + (up & -up).bit_length() - 1 if up else IPT + st


def _elem(t, i, att, mode):
    """op_elem_b: (val, flg, cnt, npix) and the foreign flag of the op at
    staged byte i."""
    b0, b1, b2, b3, b4 = (int(x) for x in t[i: i + 5])
    luma, rgb, rgba = (b0 & 0xC0) == 0x80, b0 == 0xFE, b0 == 0xFF
    vg = (b0 & 0x3F) - 32
    anc, anc_a = rgb or rgba, rgba and mode != "noalpha"
    r = g = bl = a = 0
    if mode == "mono":
        r = b1 if anc else (vg if luma else 0)
        a = b2 if anc_a else 0
    else:
        r = b1 if anc else (vg - 8 + ((b1 >> 4) & 15) if luma else 0)
        g = b2 if anc else (vg if luma else 0)
        bl = b3 if anc else (vg - 8 + (b1 & 15) if luma else 0)
        a = (b4 if anc_a else 0) + (att if mode == "alpha" else 0)
    npix = (b0 & 0x3F) + 1
    if luma or anc or b0 < 0x60:
        npix = 1
    if b0 == 0xFD:
        npix = 512
    foreign = (b0 < 0x80 or rgba) if mode == "noalpha" else b0 < 0x60
    val = (r & 255) | ((g & 255) << 8) | ((bl & 255) << 16) | ((a & 255) << 24)
    return (val, int(anc) | (int(anc_a) << 1), 1, npix), foreign


def lookback_front(data, clen, n_max, mode, seed=0, p_prefix=0.05):
    """csrc/frontend.cu's single-row path in Python, tile by tile in the
    counter's order: the staged bytes (zero from the stream's end + HALO
    on), each thread's map by step6, the block's exclusive scans, the three
    look-backs (map; (val, flg); (cnt, npix)), the tile's op list (and in
    mode noalpha the alpha peek after the stream's last op) from each
    thread's state-0 bytes, dealt out as equal runs of consecutive ops, the
    ops below n_max at their ranks, and totals from the tile where the
    pixel count reaches n_max, or else the row's last tile before the
    stream's end.
    Returns (keys, payloads, totals, has_ref) as numpy arrays, the entries
    past totals 0; and the tiles entered inside a token."""
    rng = np.random.default_rng(seed)
    bsz, m = data.shape
    nt = max(1, -(-m // TILE))
    keys = np.zeros((bsz, m), np.int64)
    pays = np.zeros((bsz, m), np.int64)
    totals = np.zeros(bsz, np.int64)
    has_ref = np.zeros(bsz, np.int64)
    inside = 0
    for row in range(bsz):
        live_end = min(int(clen[row]), m)
        status = {k: {} for k in OPS}
        for tile in range(nt):
            base = tile * TILE
            if base >= live_end:
                break
            n = min(min(m, live_end + HALO) - base, TILE + HALO)
            t = np.zeros(TILE + 16, np.int64)
            t[:n] = data[row, base: base + n]
            lens, atts = zip(*(_tok(t, i, mode) for i in range(TILE)))
            lens = [1 if base + i < HDR1 else x for i, x in enumerate(lens)]
            maps = []
            for th in range(NT):
                mp = IDENT6
                for j in range(IPT):
                    mp = step6(mp, lens[th * IPT + j] - 1)
                maps.append(mp)

            def block_scan(vals, op, ident):
                ex, run = [], ident
                for v in vals:
                    ex.append(run)
                    run = op(run, v)
                return ex, run

            def publish(kind, agg):
                ex = (IDENT[kind] if tile == 0 else
                      _look_back(kind, status[kind], tile, rng, p_prefix))
                status[kind][tile] = (agg, OPS[kind](ex, agg))
                return ex

            ex_map, agg_map = block_scan(maps, compose6, IDENT6)
            s0 = publish("map", agg_map) & 7
            inside += s0 != 0
            states = [(e >> (3 * s0)) & 7 for e in ex_map]

            ops = []  # the tile's ops in order: their staged bytes
            for th in range(NT):
                state, p0, tz = states[th], base + th * IPT, 0
                for j in range(IPT):
                    tz |= (state == 0) << j
                    i = th * IPT + j
                    state = lens[i] - 1 if state == 0 else state - 1
                lo = min(max(HDR1 - p0, 0), IPT)
                hi = min(max(live_end - p0, 0), IPT)
                tm = tz & ((1 << hi) - 1) & ~((1 << lo) - 1)
                ops += [th * IPT + j for j in range(IPT) if tm >> j & 1]
                if (mode == "noalpha" and 0 < live_end - p0 <= IPT
                        and live_end > HDR1):
                    b = int(t[th * IPT + end_peek(tz, hi, state)])
                    has_ref[row] |= 0x60 <= b < 0x80
            elems = [_elem(t, i, atts[i], mode) for i in ops]
            per = -(-len(ops) // NT)  # consecutive ops a thread
            runs = [range(min(th * per, len(ops)),
                          min(th * per + per, len(ops))) for th in range(NT)]
            accs = []
            for rn in runs:
                acc = (0, 0, 0, 0)
                for k in rn:
                    acc = chan_op(acc, elems[k][0])
                accs.append(acc)
            ex_c, agg = block_scan(accs, chan_op, (0, 0, 0, 0))
            pv = publish("val", agg[:2])
            pc = publish("cnt", agg[2:])
            has_ref[row] |= any(f for _, f in elems)
            here = 0
            for th, rn in enumerate(runs):
                run = chan_op(pv + pc, ex_c[th])
                for k in rn:
                    key = run[3]
                    run = chan_op(run, elems[k][0])
                    if key < n_max:
                        v, f, c, _ = run
                        a = (v >> 24) & 255
                        a = a if f & 2 else (a + 255) & 255
                        keys[row, c - 1] = key
                        pays[row, c - 1] = (v & 0xFFFFFF) | (a << 24)
                        here += 1
            incl = min(pc[1] + agg[3], I32MAX)
            if pc[1] < n_max <= incl:
                totals[row] = pc[0] + here
            elif incl < n_max and tile == (live_end - 1) // TILE:
                totals[row] = pc[0] + agg[2]
    for row in range(bsz):
        keys[row, totals[row]:] = 0
        pays[row, totals[row]:] = 0
    return (keys.astype(np.int32), pays.astype(np.uint32).view(np.int32),
            totals.astype(np.int32), has_ref.astype(np.int32), inside)


def _edge_stream(mode, m=3 * TILE + 200):
    """Synthetic op bytes with tokens across tile edges: an RGBA op and
    its alpha modifier, an RGB op, a LUMA op, and a modifier alone right
    after an edge, between runs of 1-byte ops."""
    s = np.full(m, 0xC1, np.uint8)  # a run of 2 pixels
    s[:HDR1] = 0
    for edge, token in ((TILE, [0xFF, 1, 2, 3, 200, 0x65]),
                        (2 * TILE, [0xFE, 9, 8, 7]),
                        (2 * TILE + 100, [0x9A, 0x37]),
                        (3 * TILE, [0xFF, 5, 6, 7, 8, 0x7F])):
        at = edge - 3 if edge % TILE == 0 else edge
        s[at: at + len(token)] = token
    s[TILE + 50: TILE + 60] = 0xFD  # BIGRUNs
    if mode == "mono":
        s[2 * TILE - 1: 2 * TILE + 2] = [0xFF, 40, 90]
    return s


def _front_model_cases():
    cases = {}
    for name in ("alpha_mods_16384", "noalpha_16384", "mono_runs_16384",
                 "truncated_16384"):
        cases[name] = CASES[name]
    for mode in ("alpha", "noalpha", "mono"):
        s = _edge_stream(mode)
        data = np.stack([s, s, s])
        cases[f"edges_{mode}"] = dict(
            data=data, mode=mode,
            # the stream's end past the last tile, inside it, and an n_max
            # that cuts the last ops
            clen=np.array([len(s) - 8, 2 * TILE + 1, len(s) - 8], np.int32),
            n_max=16000 if mode != "mono" else 1 << 20)
    data, clen, _ = corpus.end_peek_rows(TILE)
    cases["end_peek_noalpha"] = dict(data=data, clen=clen, mode="noalpha",
                                     n_max=1 << 16)
    return cases


@pytest.mark.parametrize("name", list(_front_model_cases()))
def test_lookback_front_model_matches_plain(name):
    c = _front_model_cases()[name]
    want = frontend.decode_front_plain(
        torch.from_numpy(c["data"]), torch.from_numpy(c["clen"]), c["n_max"],
        c["mode"])
    for seed, p_prefix in ((0, 0.1), (1, 0.7)):
        *got, inside = lookback_front(c["data"], c["clen"], c["n_max"],
                                      c["mode"], seed, p_prefix)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
        if name.startswith("edges"):
            assert inside >= 3  # tiles entered inside a token


def test_end_peek_case_is_flagged():
    """The plain version flags the rows of the end-peek case where the
    alpha-range byte sits where the reference peeks, and no other."""
    data, clen, hits = corpus.end_peek_rows(TILE)
    ref = frontend.decode_front_plain(torch.from_numpy(data),
                                      torch.from_numpy(clen), 1 << 16,
                                      "noalpha")[3]
    assert ref.tolist() == hits


def test_chan_split_is_exact():
    """ChanOp folds (val, flg) and (cnt, npix) independently: the two
    look-backs' combines, through their status words' packings, give
    ChanOp's result, pixel counts saturating at 2**31 - 1 included."""
    rng = np.random.default_rng(5)
    big = [0, 1, 512, I32MAX - 1000, I32MAX]
    for _ in range(2000):
        el = []
        for _ in range(2):
            el.append((int(rng.integers(0, 2**32)), int(rng.integers(0, 4)),
                       int(rng.integers(0, 2**30)),
                       int(rng.choice(big)) if rng.random() < 0.5
                       else int(rng.integers(0, 2**31))))
        left, right = el
        whole = chan_op(left, right)
        pv, uv = PACK["val"]
        pc, uc = PACK["cnt"]
        v = val_op(uv(pv(left[:2])), uv(pv(right[:2])))
        c = cnt_op(uc(pc(left[2:])), uc(pc(right[2:])))
        assert v + c == whole
        assert uc(pc(c)) == c and pc(c) < 1 << 62
        assert uv(pv(v)) == v and pv(v) < 1 << 62


def test_step6_is_compose6():
    for m in (IDENT6, 0, 5 * 0x9249, 0x2C688):
        for c in range(6):
            base = sum((e - 1) << (3 * e) for e in range(1, 6))
            assert step6(m & 0x3FFFF, c) == compose6(m & 0x3FFFF, base + c)


@pytest.mark.parametrize("bsz, m, k, words", [
    (1, 4096, 1, 2 * (3 + 1)), (1, 4097, 1, 2 * (6 + 1)),
    (32, 2097152, 1, 2 * (3 * 32 * 512 + 1)),
    (1, 227180544, 1, 2 * (3 * 55464 + 1)),
    (4, 32768, 4, 2 * (4 * 4 * 8 + 1)), (3, 2048, 16, 2 * (4 * 3 + 1))])
def test_front_scratch(bsz, m, k, words):
    assert frontend.scratch_words(bsz, m, k) == words


def _vcmpeq4(a, b):
    """__vcmpeq4: 0xFF in each byte where a and b agree."""
    return sum(0xFF << (8 * k) for k in range(4)
               if (a >> (8 * k)) & 255 == (b >> (8 * k)) & 255)


def lens4(words, q, mode):
    """csrc/frontend.cu's lens4: token length - 1 of bytes 4q..4q+3, one a
    byte, from per-byte compares of the run's words."""
    w = words[q]
    luma = _vcmpeq4(w & 0xC0C0C0C0, 0x80808080)
    rgb, rgba = _vcmpeq4(w, 0xFEFEFEFE), _vcmpeq4(w, 0xFFFFFFFF)
    if mode == "mono":
        return (rgb & 0x01010101) | (rgba & 0x02020202)
    if mode == "noalpha":
        return (luma & 0x01010101) | (rgb & 0x03030303)

    def alpha_after(k):
        pair = words[q + k // 4] | (words[q + k // 4 + 1] << 32)
        return _vcmpeq4((pair >> (8 * (k % 4))) & 0xE0E0E0E0, 0x60606060)
    one = ~(luma | rgb | rgba) & 0xFFFFFFFF
    ext = ((one & alpha_after(1)) | (luma & alpha_after(2))
           | (rgb & alpha_after(4)) | (rgba & alpha_after(5)))
    return (((luma & 0x01010101) | (rgb & 0x03030303) | (rgba & 0x04040404))
            + (ext & 0x01010101))


@pytest.mark.parametrize("mode", ["alpha", "noalpha", "mono"])
def test_lens4_matches_token_lengths(mode):
    """The four-bytes-at-a-time token lengths equal tok_len's, byte by byte,
    on runs rich in op tags and alpha-range modifiers."""
    rng = np.random.default_rng(9)
    tags = np.array([0x80, 0xBF, 0x95, 0xFE, 0xFF, 0x60, 0x7F, 0x65, 0xC1,
                     0xFD, 0x05, 0x5F], np.int64)
    for _ in range(300):
        run = np.where(rng.random(24) < 0.7, rng.choice(tags, 24),
                       rng.integers(0, 256, 24))
        words = [int(sum(int(run[4 * i + k]) << (8 * k) for k in range(4)))
                 for i in range(6)]
        for q in range(4):
            got = lens4(words, q, mode)
            for b in range(4):
                want = _tok(run, 4 * q + b, mode)[0] - 1
                assert (got >> (8 * b)) & 255 == want
