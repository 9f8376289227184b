"""K5 (compaction): the port's plain version against the Pallas kernel.

A subprocess runs ``pallas_engine.compact`` in interpret mode; the port's
``ops/compact.compact`` runs its plain version on the CPU. Both see the same
masks, keys and payloads, made from a seed with numpy, with one and two
payloads, at (2, 32768) and at (1, 65536), where the Pallas kernel carries
its cursor and partial row across tiles. The comparison is exact over the
valid region: the totals, and the keys and payloads below them
(``convert.compact`` trims the Pallas slack).

``lookback_compact`` models ``csrc/compact.cu`` in PyTorch: each thread's
count of 16 mask bytes, the block's warp-shuffle scan, the tiles' output
bases from the decoupled look-back walk of ``test_torch_scan`` (its sum
combine), each kept entry's rank and each row's total from its last tile.
It is held against the plain version, which is also held against numpy's
boolean index at the edge shapes ``chip_smoke.py`` checks the kernel at.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seqoia_tpu_torch import convert
from seqoia_tpu_torch.ops import compact, scan
from test_torch_scan import EDGE_SHAPES, IPT, NW, _walk, _warp_scan

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_engine

inp = np.load(sys.argv[1])
out = {}
for name in [str(n) for n in inp["names"]]:
    n_pay = int(inp[name + "/n_pay"])
    keys, pays, totals = pallas_engine.compact(
        jnp.asarray(inp[name + "/valid"]), jnp.asarray(inp[name + "/key"]),
        [jnp.asarray(inp[name + "/pay"][i]) for i in range(n_pay)])
    out[name + "/keys"] = np.asarray(keys)
    out[name + "/pays"] = np.stack([np.asarray(p) for p in pays])
    out[name + "/totals"] = np.asarray(totals)
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def _case(rng, shape, n_pay, density):
    b, m = shape
    valid = rng.random(shape) < density
    # keys strictly increasing along each row, payloads any int32
    key = np.cumsum(rng.integers(1, 4, shape), axis=1).astype(np.int32)
    i32 = np.iinfo(np.int32)
    pay = rng.integers(i32.min, i32.max, (n_pay, b, m), dtype=np.int32)
    return dict(valid=valid, key=key, pay=pay, n_pay=n_pay)


def _cases():
    rng = np.random.default_rng(31)
    return {
        "rows2_pay1": _case(rng, (2, 32768), 1, 0.3),
        "rows2_pay2": _case(rng, (2, 32768), 2, 0.7),
        "tiles2_pay2": _case(rng, (1, 65536), 2, 0.5),
        "tiles2_pay1_sparse": _case(rng, (1, 65536), 1, 0.001),
        "rows2_pay2_none": _case(rng, (2, 32768), 2, 0.0),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k5")
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
def test_compact_plain_matches_pallas(name, pallas_out):
    c = CASES[name]
    m = c["key"].shape[1]
    keys, pays, totals = compact.compact(
        torch.from_numpy(c["valid"]), convert.tensor(c["key"]),
        [convert.tensor(p) for p in c["pay"]])
    wk, wp, wt = convert.compact(
        pallas_out[name + "/keys"], list(pallas_out[name + "/pays"]),
        pallas_out[name + "/totals"], m)
    assert torch.equal(totals, wt)
    assert totals.tolist() == c["valid"].sum(axis=1).tolist()
    # the plain version leaves zeros past totals, as convert.compact does
    assert torch.equal(keys, wk)
    assert len(pays) == len(wp) == c["n_pay"]
    for got, want in zip(pays, wp):
        assert torch.equal(got, want)


def test_compact_takes_an_integer_mask_and_checks_shapes():
    key = torch.arange(6, dtype=torch.int32)[None]
    valid = torch.tensor([[0, 3, 0, 1, 1, 0]], dtype=torch.int32)
    keys, (pay,), totals = compact.compact(valid, key, [key * 10])
    assert totals.tolist() == [3]
    assert keys[0, :3].tolist() == [1, 3, 4]
    assert pay[0, :3].tolist() == [10, 30, 40]
    with pytest.raises(ValueError, match="payload"):
        compact.compact(valid, key, [key, key, key])
    with pytest.raises(ValueError, match="int32"):
        compact.compact(valid, key.long(), [key])


# --- the look-back kernel's ranks -------------------------------------------


def lookback_compact(valid, key, payloads, seed=0, p_prefix=0.05):
    """csrc/compact.cu's arithmetic in PyTorch: each kept entry's output
    position from the thread counts, the block scan and the look-back over
    the tiles' counts; the streams placed there and the totals."""
    comb = scan.COMBINES["sum"][2]
    rng = np.random.default_rng(seed)
    bsz, m = valid.shape
    nt = scan.n_tiles(m)
    v = torch.zeros(bsz, nt * scan.TILE, dtype=torch.int64)
    v[:, :m] = valid.long()
    per_thread = v.view(bsz, nt, NW, 32, IPT)
    cnt = (per_thread.sum(-1),)
    _, lane_ex = _warp_scan(cnt, comb, (0,), 32)
    warp_inc, warp_ex = _warp_scan(
        (_warp_scan(cnt, comb, (0,), 32)[0][0][..., 31],), comb, (0,), NW)
    tile_agg = warp_inc[0][..., NW - 1]
    thread_ex = warp_ex[0][..., None] + lane_ex[0]
    base = torch.zeros(bsz, nt, dtype=torch.int64)
    totals = torch.zeros(bsz, dtype=torch.int32)
    for r in range(bsz):
        status = {}
        for t in range(nt):
            agg = int(tile_agg[r, t])
            ex = 0 if t == 0 else int(_walk("sum", comb, (0,), status, t, rng,
                                            p_prefix)[0][0])
            status[t] = (agg, ex + agg)
            base[r, t] = ex
            if t == nt - 1:
                totals[r] = ex + agg
    # the rank of each kept entry: the thread's prefix, then its own run
    rank = (base[:, :, None, None, None] + thread_ex[..., None]
            + per_thread.cumsum(-1) - per_thread).view(bsz, -1)[:, :m]
    outs = []
    for stream in [key] + list(payloads):
        out = torch.zeros_like(stream)
        for r in range(bsz):
            kept = valid[r]
            out[r, rank[r, kept]] = stream[r, kept]
        outs.append(out)
    return outs[0], outs[1:], totals


def _mask(rng, shape, kind):
    if kind == "none":
        return np.zeros(shape, bool)
    if kind == "all":
        return np.ones(shape, bool)
    if kind == "last":
        v = np.zeros(shape, bool)
        v[:, -1] = True
        return v
    return rng.random(shape) < 0.35


@pytest.mark.parametrize("kind", ["none", "all", "35%", "last"])
def test_lookback_model_matches_plain(kind):
    rng = np.random.default_rng(51)
    shape = (2, 37 * 4096 + 1234)  # crosses windows of 32 predecessors
    c = _case(rng, shape, 2, 0.35)
    valid = torch.from_numpy(_mask(rng, shape, kind))
    key = convert.tensor(c["key"])
    pays = [convert.tensor(p) for p in c["pay"]]
    want = compact.compact_plain(valid, key, pays)
    for seed, p_prefix in ((0, 0.02), (1, 0.5)):
        keys, got_pays, totals = lookback_compact(valid, key, pays, seed,
                                                  p_prefix)
        assert torch.equal(totals, want[2])
        assert torch.equal(keys, want[0])
        for g, w in zip(got_pays, want[1]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_plain_compact_at_edge_shapes(shape):
    rng = np.random.default_rng(52)
    c = _case(rng, shape, 2, 0.35)
    for kind in ("none", "all", "35%", "last"):
        valid = _mask(rng, shape, kind)
        keys, pays, totals = compact.compact(
            torch.from_numpy(valid), convert.tensor(c["key"]),
            [convert.tensor(p) for p in c["pay"]])
        assert totals.tolist() == valid.sum(axis=1).tolist()
        for r in range(shape[0]):
            n = int(totals[r])
            assert keys[r, :n].tolist() == c["key"][r][valid[r]].tolist()
            for got, want in zip(pays, c["pay"]):
                assert got[r, :n].tolist() == want[r][valid[r]].tolist()
