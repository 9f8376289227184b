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
