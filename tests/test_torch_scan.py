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
