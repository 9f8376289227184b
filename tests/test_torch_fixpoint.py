"""K11 (one pass of the .qoi decode's index fixpoint, fused): its design
in plain PyTorch, held to the library-op pass the CPU path runs
(``decode_compat._op_values``, ``_resolve``), and the fused route through
the decode.

``_k11_by_design`` follows ``csrc/fixpoint.cu`` step by step: each op's
element (``ops/fixpoint.elements_plain``), 4096-op tiles, each thread's
fold of 16 consecutive ops, the block's exclusive scan of the thread folds,
the carry from tile to tile that the decoupled look-back hands each tile,
then the prefix applied op by op and the pixel and hash formed. Integer
codec: exact, tolerance 0.
"""

import numpy as np
import pytest
import torch

from conftest import gen_pixels
from seqoia_tpu_torch import convert, native, spec
from seqoia_tpu_torch.codec import decode_compat
from seqoia_tpu_torch.ops import fixpoint, slots
from seqoia_tpu_torch.utils import corpus, trace

TILE, IPT = 4096, 16


def _k11_by_design(lo, hi, iv, totals, tile=TILE, ipt=IPT):
    """(px, hashes) of one K11 values launch, computed as its blocks do."""
    comb = fixpoint.combine_plain
    word, flags = fixpoint.elements_plain(lo, hi, iv, totals)
    bsz, m = word.shape
    nt = max(1, -(-m // tile))
    pad = nt * tile - m  # past a ragged tile's end: the identity

    def tiles(x):
        return torch.nn.functional.pad(x, (0, pad)).view(
            bsz, nt, tile // ipt, ipt)

    el = (tiles(word), tiles(flags))
    # each thread folds its run of ipt consecutive ops
    acc = (el[0][..., 0], el[1][..., 0])
    for j in range(1, ipt):
        acc = comb(acc, (el[0][..., j], el[1][..., j]))
    # the block's exclusive scan of the thread folds, and the tile's total
    inc = _scan(acc, comb)
    ex = tuple(torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)
               for x in inc)
    agg = tuple(x[..., -1] for x in inc)
    # the look-back: each tile's exclusive prefix is the fold of every tile
    # before it in its row
    carry = (torch.zeros_like(agg[0][:, 0]), torch.zeros_like(agg[1][:, 0]))
    prefix = []
    for t in range(nt):
        prefix.append(carry)
        carry = comb(carry, (agg[0][:, t], agg[1][:, t]))
    tex = tuple(torch.stack([p[k] for p in prefix], 1)[..., None]
                for k in range(2))
    # each thread applies its prefix op by op
    run = comb(tex, ex)
    out = ([], [])
    for j in range(ipt):
        run = comb(run, (el[0][..., j], el[1][..., j]))
        out[0].append(run[0])
        out[1].append(run[1])
    w, f = (torch.stack(o, -1).reshape(bsz, nt * tile)[:, :m] for o in out)
    return fixpoint.pixels_plain(w, f, totals)


def _scan(elems, comb):
    """Inclusive scan along the last axis, one position after another."""
    outs, run = [], None
    for i in range(elems[0].shape[-1]):
        e = tuple(x[..., i] for x in elems)
        run = e if run is None else comb(run, e)
        outs.append(run)
    return tuple(torch.stack([o[k] for o in outs], -1) for k in range(2))


def _library_pass(lo, hi, iv, totals):
    """(px, hashes, new iv, stable) of one pass as the CPU path runs it."""
    r = decode_compat._Rows(lo, hi, totals)
    px, _ = decode_compat._op_values(r.ops, iv, r.valid)
    hashes = torch.where(r.valid, spec.color_hash(
        px & 255, (px >> 8) & 255, (px >> 16) & 255, (px >> 24) & 255),
        -1).to(torch.int32)
    new_iv, stable = decode_compat._resolve(r.ops, r.valid, r.qslot, totals,
                                            iv)
    return px, hashes, new_iv, stable


def _batch(streams):
    """.qoi streams as one (B, M) uint8 batch and their chunk lengths."""
    m = max(len(s) for s in streams) + 64
    data = np.zeros((len(streams), m), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    clen = np.array([len(s) - 8 for s in streams], np.int32)
    return torch.from_numpy(data), convert.tensor(clen)


def _rows_of(streams):
    """_ops' (lo, hi, totals) of .qoi streams in one batch."""
    return decode_compat._ops(*_batch(streams))


def _with_alpha(rng, img):
    a = np.full(img.shape[:2] + (1,), 255, np.int16)
    dips = rng.random(img.shape[:2]) < 0.02
    a[dips] -= rng.integers(8, 16, (int(dips.sum()), 1))
    return np.concatenate([img, a.astype(np.uint8)], -1)


def _chain_pixels():
    """The 61-link INDEX chain (tests/test_compat_fixpoint.py)."""
    a = (25, 0, 0, 255)
    px = [a]
    for c in range(2, 64):
        if c != 43:  # this filler would hash to slot 0
            px += [(c, 40, 0, 255), a]
    return np.array(px, np.uint8).reshape(-1), len(px)


def _value_chain(links):
    """INDEX reads each of a value a DIFF op derived from the read before
    (tests/test_torch_compat.py)."""
    def slot(c):
        return (c[0] * 3 + c[1] * 5 + c[2] * 7 + c[3] * 11) % 64

    px = [(0, 40, 0, 255)]
    for i in range(1, links + 1):
        x, z = (i, 40, 0, 255), (0, 200, i, 255)
        if slot(z) == slot(x):
            z = (0, 201, i, 255)
        px += [x, z, x]
    return np.array(px, np.uint8).reshape(-1), len(px)


def _streams(case):
    rng = np.random.default_rng(2500)
    if case == "photos24":  # 24 opaque photo crops of two orientations
        return [native.encode(corpus._photo(rng, w, h).reshape(-1), w, h, 3,
                              0, 1)
                for w, h in [(72, 48), (48, 72)] * 12]
    if case == "photo":  # one crop whose ops span several tiles
        return [native.encode(corpus._photo(rng, 160, 120).reshape(-1), 160,
                              120, 3, 0, 1)]
    if case == "alpha":  # RGBA content: photos with alpha dips, a palette
        img = _with_alpha(rng, corpus._photo(rng, 64, 48))
        return [native.encode(img.reshape(-1), 64, 48, 4, 0, 1),
                native.encode(gen_pixels(rng, 40 * 30, 4, "palette"), 40, 30,
                              4, 0, 1),
                native.encode(gen_pixels(rng, 33 * 17, 4, "luma"), 33, 17, 4,
                              0, 1)]
    if case == "index_chain":
        px, n = _chain_pixels()
        return [native.encode(px, n, 1, 4, 0, 1)]
    px, n = _value_chain(100)
    return [native.encode(px, n, 1, 4, 0, 1)]


STREAM_CASES = ("photos24", "photo", "alpha", "index_chain", "value_chain")


def _ivs(lo, hi, totals):
    """The assumed INDEX values of the passes a decode runs: the zeros of
    the first pass, those after two passes, and the restart's guesses with
    the speculated alpha."""
    r = decode_compat._Rows(lo, hi, totals)
    iv0 = torch.zeros_like(lo)
    iv1, _ = r.resolve(iv0)
    iv2, _ = r.resolve(iv1)
    b0, b4 = lo & 255, hi & 255
    spec_a = _fill_alpha(b4, (b0 == spec.OP_RGBA) & r.valid)
    restart = torch.where((b0 < 64) & r.valid,
                          (iv2 & 0xFFFFFF) | (spec_a << 24), 0)
    return {"first": iv0, "third": iv2, "restart": restart}


def _fill_alpha(values, flags):
    """The alpha of the latest flagged op, 255 before any."""
    idx = torch.arange(values.shape[1])[None, :].expand(values.shape)
    last = torch.cummax(torch.where(flags, idx, -1), dim=1).values
    got = torch.gather(values, 1, last.clamp(min=0))
    return torch.where(last >= 0, got, 255)


@pytest.fixture(scope="module", params=STREAM_CASES)
def stream_rows(request):
    lo, hi, totals = _rows_of(_streams(request.param))
    return request.param, lo, hi, totals


@pytest.mark.parametrize("which", ["first", "third", "restart"])
def test_values_by_design_match_the_library_pass(stream_rows, which):
    """K11's design at its 4096-op tiles and at 64-op tiles of 4 ops a
    thread (many tiles, every carry), and the module's plain version, equal
    _op_values and the hash on the streams' ops."""
    name, lo, hi, totals = stream_rows
    iv = _ivs(lo, hi, totals)[which]
    want_px, want_h, _, _ = _library_pass(lo, hi, iv, totals)
    for tile, ipt in ((TILE, IPT), (64, 4)):
        px, h = _k11_by_design(lo, hi, iv, totals, tile, ipt)
        assert torch.equal(px, want_px), (name, tile)
        assert torch.equal(h, want_h), (name, tile)
    px, h = fixpoint.op_values(lo, hi, iv, totals)
    assert torch.equal(px, want_px) and torch.equal(h, want_h)
    px, h = fixpoint.op_values(lo, hi, iv, totals, hashes=False)
    assert torch.equal(px, want_px) and h is None


def test_pass_by_design_matches_resolve(stream_rows):
    """A whole pass (K11's values and hashes, K7, K11's check) equals
    _resolve, pass after pass until the rows settle or 20 passes ran: K7
    answers 0 wherever no INDEX op reads, so its answers are the new iv."""
    name, lo, hi, totals = stream_rows
    r = decode_compat._Rows(lo, hi, totals)
    iv = torch.zeros_like(lo)
    for _ in range(20):
        px, h = _k11_by_design(lo, hi, iv, totals)
        got = slots.slot_last_writer(h, px, r.qslot, init=0, n_live=totals)
        stable = fixpoint.settled(got, iv)
        _, _, want_iv, want_stable = _library_pass(lo, hi, iv, totals)
        assert torch.equal(got, want_iv), name
        assert torch.equal(stable, want_stable), name
        iv = got
        if bool(stable.all()):
            break


def _random_rows(shape, totals, seed):
    """Random op words (every op kind), byte-4 words and INDEX values."""
    g = torch.Generator().manual_seed(seed)

    def words():
        return torch.randint(-2**31, 2**31, shape, generator=g,
                             dtype=torch.int64).to(torch.int32)

    # lo, a view into wider rows as _ops gives it; hi a byte a word
    lo = torch.nn.functional.pad(words(), (0, 5))[:, : shape[1]]
    hi = torch.randint(0, 256, shape, generator=g, dtype=torch.int32)
    return lo, hi, words(), torch.tensor(totals, dtype=torch.int32)


@pytest.mark.parametrize("shape,totals", [
    ((1, 4095), [4095]),
    ((1, 4096), [4096]),
    ((1, 4097), [4097]),
    ((3, 3 * 4096 + 5), [3 * 4096 + 5, 0, 4096 + 1]),  # a row of no ops
    ((24, 4097), [4097 - 37 * i for i in range(24)]),
    ((2, 1), [0, 1]),
])
def test_values_by_design_at_tile_edges(shape, totals):
    lo, hi, iv, tot = _random_rows(shape, totals, seed=shape[1])
    want_px, want_h, want_iv, want_stable = _library_pass(lo, hi, iv, tot)
    px, h = _k11_by_design(lo, hi, iv, tot)
    assert torch.equal(px, want_px) and torch.equal(h, want_h)
    assert torch.equal(fixpoint.op_values(lo, hi, iv, tot)[0], want_px)
    assert (h[torch.arange(shape[1])[None, :] >= tot[:, None]] == -1).all()
    r = decode_compat._Rows(lo, hi, tot)
    got = slots.slot_last_writer(h, px, r.qslot, init=0, n_live=tot)
    assert torch.equal(got, want_iv)
    assert torch.equal(fixpoint.settled(got, iv), want_stable)
    assert torch.equal(fixpoint.settled(got, got), torch.ones(shape[0],
                                                              dtype=bool))


def test_restart_subset_by_design():
    """The restart's rows: a subset of the 24 photos taken as _settle takes
    them, from the speculated alpha, equal on the library pass."""
    lo, hi, totals = _rows_of(_streams("photos24"))
    rows = torch.tensor([1, 5, 6, 23])
    r = decode_compat._Rows(lo, hi, totals).take(rows)
    iv = _ivs(r.lo, r.hi, r.totals)["restart"]
    want_px, want_h, want_iv, want_stable = _library_pass(r.lo, r.hi, iv,
                                                          r.totals)
    px, h = _k11_by_design(r.lo, r.hi, iv, r.totals)
    assert torch.equal(px, want_px) and torch.equal(h, want_h)
    fused = _FusedRows(r.lo, r.hi, r.totals)
    got, stable = fused.resolve(iv)
    assert torch.equal(got, want_iv) and torch.equal(stable, want_stable)
    assert torch.equal(fused.values(iv), want_px)


class _FusedRows(decode_compat._Rows):
    """_Rows with its passes on the card's route (K11, K7, K11's check),
    which runs the kernels' plain versions on the CPU."""

    def __init__(self, *a):
        super().__init__(*a)
        self.ops = None


@pytest.mark.parametrize("case", STREAM_CASES)
def test_decode_through_the_fused_route(monkeypatch, case):
    """decode_stream_compat_batched with every pass on the card's route:
    the pixels equal the native decoder's, the stats equal the library
    route's, and codec.fixpoint.fused counts each pass, fixpoint and
    restart alike."""
    streams = _streams(case)
    data, clen = _batch(streams)
    descs = [native.decode(s)[1] for s in streams]
    npx = torch.tensor([w * h for w, h, *_ in descs])
    n_max = -(-int(npx.max()) // 4) * 4

    def run():
        stats = {}
        out, conv = decode_compat.decode_stream_compat_batched(
            data, clen, npx, colch=3, out_ch=4, n_max=n_max, stats=stats)
        return out, conv, stats

    want = run()
    monkeypatch.setattr(decode_compat, "_Rows", _FusedRows)
    before = trace.counters().get("codec.fixpoint.fused", 0)
    out, conv, stats = run()
    fused = trace.counters().get("codec.fixpoint.fused", 0) - before
    assert torch.equal(out, want[0]) and torch.equal(conv, want[1])
    assert stats == want[2]
    assert fused == stats["passes"] + stats["settle_passes"]
    for i, s in enumerate(streams):
        px, _ = native.decode(s, 4)
        assert np.array_equal(out[i, : len(px)].numpy(), px), (case, i)


def test_fused_route_counts_no_pass_on_the_library_route():
    """The CPU path runs _resolve: codec.fixpoint.fused counts only the
    passes that K11 ran."""
    lo, hi, totals = _rows_of(_streams("index_chain"))
    before = trace.counters().get("codec.fixpoint.fused", 0)
    decode_compat._Rows(lo, hi, totals).resolve(torch.zeros_like(lo))
    assert trace.counters().get("codec.fixpoint.fused", 0) == before


def test_op_values_and_settled_check_their_arguments():
    x = torch.zeros((2, 8), dtype=torch.int32)
    t = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fixpoint.op_values(x.long(), x, x, t)
    with pytest.raises(ValueError, match="one shape"):
        fixpoint.op_values(x, x[:, :4], x, t)
    with pytest.raises(ValueError, match="totals"):
        fixpoint.op_values(x, x, x, torch.zeros(3))
    with pytest.raises(ValueError, match="device"):
        fixpoint.op_values(x.to("meta"), x.to("meta"), x.to("meta"),
                           t.to("meta"))
    with pytest.raises(ValueError, match="one shape and device"):
        fixpoint.op_values(x, x, x.to("meta"), t)
    with pytest.raises(ValueError, match="one shape"):
        fixpoint.settled(x, x[:, :4])
    with pytest.raises(ValueError, match="one shape and device"):
        fixpoint.settled(x, x.to("meta"))
    with pytest.raises(ValueError, match="device"):
        fixpoint.settled(x.to("meta"), x.to("meta"))
