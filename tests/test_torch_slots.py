"""K7 (per-slot last writer): the port's plain version against the Pallas
kernel.

A subprocess runs ``pallas_slots.slot_last_writer`` in interpret mode; the
port's ``ops/slots.slot_last_writer`` runs its plain version on the CPU.
Both see the same hashes, values and query slots, made from a seed with
numpy: 64 and 128 slots, init 0 and nonzero, non-writers and non-queries
marked -1 (and out-of-range slots), n_live below M, and rows of two
32768-entry tiles, where the Pallas kernel carries its table across tiles.
Exact comparison below n_live; past it the port returns init everywhere,
the Pallas kernel in the tiles it skips (it computes the rest of a tile
that n_live cuts).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from seqoia_tpu_torch import convert
from seqoia_tpu_torch.ops import slots

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TILE = 32768

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.ops import pallas_slots

inp = np.load(sys.argv[1])
out = {}
for name in [str(n) for n in inp["names"]]:
    out[name] = np.asarray(pallas_slots.slot_last_writer(
        *(jnp.asarray(inp[name + "/" + k]) for k in ("hashes", "values",
                                                     "qslots")),
        n_slots=int(inp[name + "/n_slots"]), init=int(inp[name + "/init"]),
        n_live=jnp.asarray(inp[name + "/n_live"])))
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def _case(rng, shape, n_slots, init, n_live, p_write=0.7, p_query=0.3):
    # slots drawn from a few hot ones and the whole range, -1 and one
    # out-of-range value marking non-writers / non-queries
    def slot_stream(p):
        s = np.where(rng.random(shape) < 0.5, rng.integers(0, 4, shape),
                     rng.integers(0, n_slots, shape))
        s = np.where(rng.random(shape) < p, s, -1)
        return np.where(rng.random(shape) < 0.01, n_slots + 3, s).astype(
            np.int32)

    i32 = np.iinfo(np.int32)
    return dict(hashes=slot_stream(p_write),
                values=rng.integers(i32.min, i32.max, shape, dtype=np.int32),
                qslots=slot_stream(p_query), n_slots=n_slots, init=init,
                n_live=np.asarray(n_live, np.int32))


def _cases():
    rng = np.random.default_rng(41)
    return {
        "s64_init0": _case(rng, (2, _TILE), 64, 0, [_TILE, _TILE]),
        "s64_init_live": _case(rng, (2, _TILE), 64, -12345, [20000, 0]),
        "s128_tiles2": _case(rng, (1, 2 * _TILE), 128, 7, [2 * _TILE]),
        "s128_tiles2_live": _case(rng, (2, 2 * _TILE), 128, 0,
                                  [_TILE + 1000, _TILE - 3],
                                  p_write=0.002, p_query=0.5),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("k7")
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
def test_slot_last_writer_plain_matches_pallas(name, pallas_out):
    c = CASES[name]
    got = slots.slot_last_writer(
        *(convert.tensor(c[k]) for k in ("hashes", "values", "qslots")),
        n_slots=c["n_slots"], init=c["init"],
        n_live=convert.tensor(c["n_live"])).numpy()
    want = pallas_out[name]
    m = got.shape[1]
    for r, live in enumerate(c["n_live"].tolist()):
        assert np.array_equal(got[r, :live], want[r, :live]), f"row {r}"
        assert (got[r, live:] == c["init"]).all()
        skipped = -(-live // _TILE) * _TILE  # tiles the Pallas kernel skips
        assert np.array_equal(got[r, skipped:], want[r, skipped:])
        if live == m:
            # some queries resolve to a writer, some to init
            hit = got[r] != c["init"]
            assert 0 < hit.sum() < (c["qslots"][r] >= 0).sum()


def test_slot_last_writer_semantics():
    """A writer is not seen by the query at its own position; the latest
    earlier writer of the queried slot wins."""
    h = torch.tensor([[3, 3, -1, 5, 3, 3]], dtype=torch.int32)
    v = torch.tensor([[10, 11, 12, 13, 14, 15]], dtype=torch.int32)
    q = torch.tensor([[3, 3, 3, 5, 5, 3]], dtype=torch.int32)
    out = slots.slot_last_writer(h, v, q, n_slots=8, init=-1)
    assert out.tolist() == [[-1, 10, 11, -1, 13, 14]]
    out = slots.slot_last_writer(h, v, q, n_slots=4, init=-1,
                                 n_live=torch.tensor([5]))
    assert out.tolist() == [[-1, 10, 11, -1, -1, -1]]
    with pytest.raises(ValueError, match="n_slots"):
        slots.slot_last_writer(h, v, q, n_slots=129)


# --- the look-back kernel's design (csrc/slots.cu) --------------------------

NT, NW = 256, 8          # threads and warps a block
TILE = 4096              # entries a tile
WRUN = TILE // NW        # entries a warp: 16 groups of 32
AGG, PREFIX = 1, 2


def _slot_prefix(status, tile, k, rng, p_prefix):
    """slot_prefix: slot k's predecessors read four at a time, each in a
    random published state (an unpublished one is read again, as the thread
    waits), folded by max until one is an inclusive prefix."""
    ex = -1
    j = tile - 1
    while True:
        for u in range(4):
            if j - u < 0:
                return ex
            agg, prefix = status[j - u]
            seen = AGG if rng.random() >= p_prefix else PREFIX
            ex = max(ex, int((agg if seen == AGG else prefix)[k]))
            if seen == PREFIX:
                return ex
        j -= 4


def lookback_slots(hashes, values, qslots, n_slots, init, n_live, seed=0,
                   p_prefix=0.05):
    """csrc/slots.cu's arithmetic in PyTorch: tiles in the counter's order,
    each warp's table of last writers, the fold of the warp tables, the
    per-slot look-back, and each warp's groups of 32 resolved by class
    masks (a lane's writer in its own group is the highest lower lane of
    its slot's class, else the warp's running table)."""
    rng = np.random.default_rng(seed)
    h_all, v_all, q_all = (torch.as_tensor(np.asarray(a)).long()
                           for a in (hashes, values, qslots))
    bsz, m = h_all.shape
    S = n_slots
    nt = max(1, -(-m // TILE))
    out = torch.full((bsz, m), init, dtype=torch.long)
    lanes = torch.arange(32)
    for r in range(bsz):
        live = max(min(int(n_live[r]), m), 0)
        status = {}
        for t in range(nt):
            t0 = t * TILE
            if t0 >= live:  # this tile and all after it: init, no status
                break
            idx = t0 + torch.arange(TILE)
            inside = idx < live
            cut = idx.clamp(max=m - 1)

            def slots_of(a):
                s = torch.where(inside, a[r, cut], -1)
                return torch.where((s >= 0) & (s < S), s, -1)
            h, q = slots_of(h_all), slots_of(q_all)
            tab = torch.full((NW, S), -1, dtype=torch.long)
            for w in range(NW):
                run = slice(w * WRUN, (w + 1) * WRUN)
                wr = h[run] >= 0
                tab[w].scatter_reduce_(0, h[run][wr], idx[run][wr], "amax")
            agg = torch.full((S,), -1, dtype=torch.long)
            for w in range(NW):  # every warp's exclusive prefix
                tab[w], agg = agg.clone(), torch.maximum(agg, tab[w])
            ex = torch.tensor([-1 if t == 0 else
                               _slot_prefix(status, t, k, rng, p_prefix)
                               for k in range(S)])
            status[t] = (agg, torch.maximum(ex, agg))
            tab = torch.maximum(tab, ex[None, :])
            for w in range(NW):
                cls = torch.zeros(S, dtype=torch.long)
                for g in range(WRUN // 32):
                    e = w * WRUN + 32 * g + lanes
                    hv, qv = h[e], q[e]
                    same = (hv[:, None] == hv[None, :]) & (hv[:, None] >= 0)
                    mask = (same.long() << lanes[None, :]).sum(1)
                    high = torch.tensor([int(x).bit_length() - 1
                                         for x in mask.tolist()])
                    top = (hv >= 0) & (high == lanes)
                    cls[hv[top]] = mask[top]
                    wrt = torch.full((32,), -1, dtype=torch.long)
                    first = int(idx[e[0]])
                    for ln in torch.nonzero(qv >= 0).flatten().tolist():
                        mm = int(cls[qv[ln]]) & ((1 << ln) - 1)
                        wrt[ln] = (first + mm.bit_length() - 1 if mm
                                   else int(tab[w, qv[ln]]))
                    tab[w, hv[top]] = idx[e[top]]
                    cls[hv[top]] = 0
                    keep = (idx[e] < m) & (wrt >= 0)
                    out[r, idx[e][keep]] = v_all[r, wrt[keep]]
    return out.to(torch.int32).numpy()


def _model_cases():
    rng = np.random.default_rng(43)
    cases = dict(CASES)
    # the encode's form: every position writes and queries its own slot
    for S, shape, live in ((64, (1, 3 * TILE + 5), [3 * TILE + 5]),
                           (128, (2, 2 * TILE), [TILE + 777, 2 * TILE])):
        c = _case(rng, shape, S, -3, live, p_write=0.9)
        c["qslots"] = c["hashes"]
        cases[f"dense_s{S}"] = c
    return cases


@pytest.mark.parametrize("name", list(_model_cases()))
def test_lookback_slots_model_matches_plain(name):
    c = _model_cases()[name]
    want = slots.slot_last_writer(
        *(convert.tensor(c[k]) for k in ("hashes", "values", "qslots")),
        n_slots=c["n_slots"], init=c["init"],
        n_live=convert.tensor(c["n_live"])).numpy()
    for seed, p_prefix in ((0, 0.05), (1, 0.6)):
        got = lookback_slots(c["hashes"], c["values"], c["qslots"],
                             c["n_slots"], c["init"], c["n_live"], seed,
                             p_prefix)
        assert np.array_equal(got, want), (seed, p_prefix)


def test_lookback_slots_model_matches_pallas(pallas_out):
    """The model agrees with the Pallas kernel in interpret mode below
    n_live (past it the Pallas kernel computes the tile that n_live cuts)."""
    for name, c in CASES.items():
        got = lookback_slots(c["hashes"], c["values"], c["qslots"],
                             c["n_slots"], c["init"], c["n_live"])
        for r, live in enumerate(c["n_live"].tolist()):
            assert np.array_equal(got[r, :live], pallas_out[name][r, :live])


@pytest.mark.parametrize("bsz, m, n_slots, tiles", [
    (1, 1, 64, 1), (1, 4096, 64, 1), (1, 4097, 128, 2),
    (32, 771453, 64, 189), (1, 11807483, 64, 2883)])
def test_slots_scratch(bsz, m, n_slots, tiles):
    # a 64-bit counter and one 64-bit status word per tile and slot
    assert slots.scratch_words(bsz, m, n_slots) == 2 * (
        bsz * tiles * n_slots + 1)
