"""K8 (tile scan) and the compat paths' scan primitives: the port's plain
versions against the JAX package.

A subprocess runs ``pallas_scan``'s wrappers in interpret mode (the flag
must be set before seqoia_tpu loads) at (2, 65536), two of the TPU
kernel's 32768-entry tiles per row, so its cross-tile carry is crossed. The
port's ``ops/scan`` wrappers take the same inputs, made from a seed with
numpy, on the CPU (their plain versions). The JAX ``scan_ops`` (its XLA
path on the CPU, in this process) is held against its counterparts in the
port: the K8 wrappers and the helpers ``scan_ops`` keeps. Integer scans:
exact, tolerance 0.

``lookback_scan`` is a model of ``csrc/scan.cu`` in PyTorch: the same
tiles, thread runs, warp-shuffle scans and decoupled look-back walk, with
the predecessors' status words read in random states. Held against the
plain version, it pins the order of every fold the CUDA code must follow
(none of the combines commute). The plain version is also held against a
sequential scan at the edge shapes ``chip_smoke.py`` checks the kernel at.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqoia_tpu.ops import scan_ops as jax_scan_ops
from seqoia_tpu_torch import convert
from seqoia_tpu_torch.ops import scan, scan_ops
from seqoia_tpu_torch.ops._plain import to_i32

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_scan

inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
out = {
    "max": pallas_scan.cummax(inp["max"]),
    "sum": pallas_scan.cumsum(inp["sum"]),
    "fill": pallas_scan.fill_forward(inp["fill_v"], inp["fill_f"] != 0, 77),
    "segmod": pallas_scan.segmented_modsum(inp["segmod"]),
    "maps": pallas_scan.compose_state_maps(inp["maps"]),
}
# the raw (value, flag) scan under fill_forward: 0 before the first flag
out["fill_raw_v"], out["fill_raw_f"] = pallas_scan.tile_scan(
    (inp["fill_v"], inp["fill_f"]), pallas_scan._comb_fill, (0, 0))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("PALLAS-OK")
"""

_SHAPE = (2, 65536)


def _inputs():
    rng = np.random.default_rng(21)
    i32 = np.iinfo(np.int32)
    lens = rng.choice([1, 2, 4, 5], _SHAPE)
    f0, f1 = rng.random(_SHAPE) < 0.02, rng.random(_SHAPE) < 0.3
    v0, v1 = (rng.integers(0, 256, _SHAPE) for _ in range(2))
    return {
        "max": rng.integers(i32.min, i32.max, _SHAPE, dtype=np.int32),
        # large addends, so the running sum wraps around int32
        "sum": rng.integers(0, 2**30, _SHAPE, dtype=np.int32),
        "fill_v": rng.integers(i32.min, i32.max, _SHAPE, dtype=np.int32),
        "fill_f": (rng.random(_SHAPE) < 0.001).astype(np.int32),
        "segmod": (v0 | (f0 << 8) | (v1 << 16) | (f1 << 24)).astype(np.int32),
        "maps": (lens - 1 + ((0 << 3) | (1 << 6) | (2 << 9) | (3 << 12))
                 ).astype(np.int32),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k8")
    np.savez(d / "in.npz", **INPUTS)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=600)
    assert "PALLAS-OK" in res.stdout, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _t(name):
    return convert.tensor(INPUTS[name])


@pytest.mark.parametrize("combine", ["max", "sum", "fill", "segmod", "maps"])
def test_tile_scan_plain_matches_pallas(combine, pallas_out):
    if combine == "max":
        got = scan.cummax(_t("max"))
    elif combine == "sum":
        got = scan.cumsum(_t("sum"))
    elif combine == "fill":
        got = scan.fill_forward(_t("fill_v"), _t("fill_f") != 0, 77)
    elif combine == "segmod":
        got = scan.segmented_modsum(_t("segmod"))
    else:
        got = scan.compose_state_maps(_t("maps"))
    want = convert.tensor(pallas_out[combine])
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_tile_scan_fill_raw_matches_pallas(pallas_out):
    """The (value, flag) scan itself, not only fill_forward's masked view:
    before a row's first flag the value is 0 (the kernels' identity), as in
    the Pallas kernel, which chip_smoke.py holds K8 to on the card."""
    v, f = scan.tile_scan((_t("fill_v"), _t("fill_f")), "fill")
    assert torch.equal(v, convert.tensor(pallas_out["fill_raw_v"]))
    assert torch.equal(f, convert.tensor(pallas_out["fill_raw_f"]))
    assert int(INPUTS["fill_f"][0, 0]) == 0 and int(v[0, 0]) == 0


def test_tile_scan_checks_its_arguments():
    x = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="2 array"):
        scan.tile_scan((x,), "fill")
    with pytest.raises(ValueError, match="int32"):
        scan.tile_scan((x.long(),), "max")
    with pytest.raises(ValueError, match="device"):
        scan.tile_scan((x.to("meta"),), "sum")


def _jax(x):
    return jnp.asarray(np.asarray(x))


def test_scan_ops_match_jax():
    rng = np.random.default_rng(22)
    shape = (3, 777)
    x = rng.integers(-1000, 1000, shape, dtype=np.int32)
    assert np.array_equal(scan.cummax(convert.tensor(x)).numpy(),
                          np.asarray(jax_scan_ops.hillis_max(_jax(x))))
    c = rng.integers(0, 2**24, shape, dtype=np.int32)
    assert np.array_equal(scan_ops.blocked_cumsum(convert.tensor(c)).numpy(),
                          np.asarray(jax_scan_ops.blocked_cumsum(_jax(c))))
    valid = rng.random(shape) < 0.05
    got = scan.fill_forward(convert.tensor(x), torch.from_numpy(valid), -9)
    want = jax_scan_ops.fill_forward(_jax(x), _jax(valid), -9)
    assert np.array_equal(got.numpy(), np.asarray(want))

    v0, v1 = (rng.integers(0, 256, shape, dtype=np.int32) for _ in range(2))
    f0, f1 = rng.random(shape) < 0.05, rng.random(shape) < 0.2
    ours = scan_ops.pack_pair(*(torch.from_numpy(a) for a in (v0, f0, v1, f1)))
    theirs = jax_scan_ops.pack_pair(*(_jax(a) for a in (v0, f0, v1, f1)))
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    assert np.array_equal(scan.segmented_modsum(ours).numpy(),
                          np.asarray(jax_scan_ops.segmented_modsum(theirs)))

    lens = rng.choice([1, 2, 4, 5], shape).astype(np.int32)
    maps = scan_ops.pack_state_map(convert.tensor(lens) - 1)
    assert np.array_equal(
        maps.numpy(), np.asarray(jax_scan_ops.pack_state_map(_jax(lens) - 1)))
    assert np.array_equal(
        scan.compose_state_maps(maps).numpy(),
        np.asarray(jax_scan_ops.compose_state_maps(_jax(maps.numpy()))))
    assert np.array_equal(
        scan_ops.tokenizer_states(convert.tensor(lens), 15).numpy(),
        np.asarray(jax_scan_ops.tokenizer_states(_jax(lens), 15)))


# --- the look-back kernel's order of folds ---------------------------------

NT, IPT = 256, 16  # csrc/lookback.cuh: threads a block, entries a thread
NW = NT // 32
IDENT = {"max": (scan.INT_MIN,), "sum": (0,), "fill": (0, 0), "segmod": (0,),
         "maps": (scan.IDENTITY_MAP,)}
NONE, AGG, PREFIX = 0, 1, 2


def _pack(combine, elem):
    """An element's 33 bits in a status word (int32 patterns; fill keeps
    one bit of flag)."""
    v = int(elem[0]) & 0xFFFFFFFF
    return v | (int(elem[1] != 0) << 32) if combine == "fill" else v


def _unpack(combine, word):
    v = word & 0xFFFFFFFF
    v = v - 2**32 if v >= 2**31 else v
    return (v, (word >> 32) & 1) if combine == "fill" else (v,)


def _lanes_up(elems, d, ident):
    """Each lane's value from lane l - d (__shfl_up_sync), ident below."""
    return tuple(torch.cat([torch.full_like(e[..., :d], i), e[..., :-d]], -1)
                 for e, i in zip(elems, ident))


def _warp_scan(elems, comb, ident, width):
    """Inclusive scan over the last axis (lanes) by shfl_up, op(left,
    right); returns (inclusive, exclusive)."""
    lane = torch.arange(width)
    d = 1
    while d < width:
        up = comb(_lanes_up(elems, d, ident), elems)
        elems = tuple(torch.where(lane >= d, u, e) for u, e in zip(up, elems))
        d *= 2
    return elems, _lanes_up(elems, 1, ident)


def _walk(combine, comb, ident, status, tile, rng, p_prefix, swap=False):
    """tile_prefix's look-back for one tile of one row: windows of 32
    predecessors (lane l the l-th nearest), each read in a random state (an
    unpublished one is read again, as the warp waits), folded from the
    window's farthest lane down to the nearest inclusive prefix by the
    shfl_down tree, ex = op(window, ex), until a window holds a prefix.
    swap folds with the operands exchanged, as if the combine commuted."""
    def fold(left, right):
        return comb(right, left) if swap else comb(left, right)

    ex = tuple(torch.tensor([i]) for i in ident)
    j = tile - 1
    while True:
        states, vals = [], []
        for lane in range(32):
            k = j - lane
            if k < 0:
                states.append(PREFIX)
                vals.append(ident)
                continue
            agg, prefix = status[k]
            seen = NONE
            while seen == NONE:  # published: its aggregate, maybe its prefix
                seen = rng.choice([NONE, AGG, PREFIX],
                                  p=[0.2, 0.8 - p_prefix, p_prefix])
            if seen == PREFIX and prefix is None:
                seen = AGG
            states.append(seen)
            vals.append(_unpack(combine, agg if seen == AGG else prefix))
        stop = states.index(PREFIX) if PREFIX in states else 31
        v = tuple(torch.tensor([x[a] if lane <= stop else ident[a]
                                for lane, x in enumerate(vals)])
                  for a in range(len(ident)))
        lane = torch.arange(32)
        d = 1
        while d < 32:
            down = tuple(torch.cat([e[d:], e[:d]]) for e in v)
            v = tuple(torch.where(lane + d < 32, c, e)
                      for c, e in zip(fold(down, v), v))
            d *= 2
        ex = fold(tuple(e[:1] for e in v), ex)
        if PREFIX in states:
            return ex
        j -= 32


def lookback_scan(arrays, combine, seed=0, p_prefix=0.05, swap=False):
    """csrc/scan.cu's arithmetic in PyTorch: (B, M) int32 arrays -> the
    inclusive scans, one tile of scan.TILE entries at a time."""
    _, _, comb = scan.COMBINES[combine]
    ident = IDENT[combine]
    rng = np.random.default_rng(seed)
    xs = [a.long() for a in arrays]
    if combine == "fill":  # an entry reads as (value if flagged else 0, flag)
        xs[0] = torch.where(xs[1] != 0, xs[0], 0)
    bsz, m = xs[0].shape
    nt = scan.n_tiles(m)
    x = tuple(torch.cat([e, torch.full((bsz, nt * scan.TILE - m), i)], -1)
              .view(bsz, nt, NW, 32, IPT) for e, i in zip(xs, ident))
    acc = tuple(torch.full(x[0].shape[:-1], i) for i in ident)
    for j in range(IPT):  # each thread's run, left to right
        acc = comb(acc, tuple(e[..., j] for e in x))
    _, lane_ex = _warp_scan(acc, comb, ident, 32)
    warp_inc, warp_ex = _warp_scan(tuple(e[..., 31] for e in _warp_scan(
        acc, comb, ident, 32)[0]), comb, ident, NW)
    tile_agg = tuple(e[..., NW - 1] for e in warp_inc)  # (B, nt)
    thread_ex = comb(tuple(e[..., None] for e in warp_ex), lane_ex)
    tile_ex = [[None] * nt for _ in range(bsz)]
    for r in range(bsz):  # tiles in the counter's order
        status = {}
        for t in range(nt):
            agg = tuple(e[r, t:t + 1] for e in tile_agg)
            ex = (tuple(torch.tensor([i]) for i in ident) if t == 0 else
                  _walk(combine, comb, ident, status, t, rng, p_prefix,
                        swap))
            status[t] = (_pack(combine, tuple(e[0] for e in agg)),
                         _pack(combine, tuple(e[0] for e in comb(ex, agg))))
            tile_ex[r][t] = ex
    run = comb(tuple(torch.stack([torch.cat([ex[a] for ex in row])
                                  for row in tile_ex])[:, :, None, None]
                     for a in range(len(ident))), thread_ex)
    outs = []
    for j in range(IPT):
        run = comb(run, tuple(e[..., j] for e in x))
        outs.append(run)
    return tuple(to_i32(torch.stack([o[a] for o in outs], -1)
                        .reshape(bsz, -1)[:, :m]) for a in range(len(ident)))


def _edge_arrays(rng, shape, combine):
    """Inputs for one combine as its callers make them (chip_smoke's edge
    checks make the same kinds on the card)."""
    i32 = np.iinfo(np.int32)
    if combine == "fill":
        arrays = (rng.integers(i32.min, i32.max, shape, dtype=np.int32),
                  (rng.random(shape) < 0.003).astype(np.int32))
    elif combine == "segmod":
        arrays = ((rng.integers(0, 2**31, shape) & 0x01FF01FF).astype(np.int32),)
    elif combine == "maps":
        arrays = ((rng.integers(0, 4, shape) + ((1 << 6) | (2 << 9) | (3 << 12))
                   ).astype(np.int32),)
    else:
        arrays = (rng.integers(i32.min, i32.max, shape, dtype=np.int32),)
    return tuple(convert.tensor(a) for a in arrays)


# two rows of 37 whole tiles and a ragged one: the walk crosses windows of
# 32 predecessors
_MODEL_SHAPE = (2, 37 * 4096 + 1234)


@pytest.mark.parametrize("combine", list(scan.COMBINES))
def test_lookback_model_matches_plain(combine):
    rng = np.random.default_rng(41)
    arrays = _edge_arrays(rng, _MODEL_SHAPE, combine)
    want = scan.tile_scan_plain(arrays, combine)
    for seed, p_prefix in ((0, 0.02), (1, 0.5)):
        got = lookback_scan(arrays, combine, seed, p_prefix)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("combine", ["fill", "segmod", "maps"])
def test_lookback_model_needs_the_order(combine):
    """The same walk with its folds' operands exchanged (the order a
    commuting combine would allow) breaks the non-commuting scans: the
    model, and the kernel it mirrors, rely on the order."""
    rng = np.random.default_rng(42)
    arrays = _edge_arrays(rng, (1, 40 * 4096 + 1), combine)
    if combine == "fill":  # flags dense enough that most tiles hold some
        arrays = (arrays[0], (arrays[0] % 512 == 0).to(torch.int32))
    want = scan.tile_scan_plain(arrays, combine)
    got = lookback_scan(arrays, combine, p_prefix=0.02, swap=True)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


def _sequential(arrays, combine):
    """Reference: the scan one position at a time, from the row identity."""
    _, _, comb = scan.COMBINES[combine]
    xs = [a.long() for a in arrays]
    if combine == "fill":
        xs[0] = torch.where(xs[1] != 0, xs[0], 0)
    run = tuple(torch.full((xs[0].shape[0],), i) for i in IDENT[combine])
    outs = []
    for j in range(xs[0].shape[1]):
        run = comb(run, tuple(e[:, j] for e in xs))
        outs.append(run)
    return tuple(to_i32(torch.stack([o[a] for o in outs], -1))
                 for a in range(len(run)))


# chip_smoke.EDGE_SHAPES but its 11.8 M-entry row, which only the card's
# plain version takes in reasonable time
EDGE_SHAPES = ((1, 1), (1, 3), (1, 4095), (1, 4096), (1, 4097),
               (1, 3 * 4096 + 1), (37, 4097), (4096, 37))


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_plain_scan_at_edge_shapes(shape):
    rng = np.random.default_rng(43)
    for combine in scan.COMBINES:
        arrays = _edge_arrays(rng, shape, combine)
        got = scan.tile_scan(arrays, combine)
        for g, w in zip(got, _sequential(arrays, combine)):
            assert torch.equal(g, w), combine


@pytest.mark.parametrize("m, tiles", [(0, 1), (1, 1), (4096, 1), (4097, 2),
                                      (3 * 4096 + 1, 4), (11807483, 2883)])
def test_lookback_scratch(m, tiles):
    assert scan.n_tiles(m) == tiles
    # a 64-bit counter and one 64-bit status word per tile, in int32 words
    assert scan.scratch_words(3, m) == 2 * (3 * tiles + 1)
