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
    (4, 3, 4096, 1),    # color forced to gray (K6 and the torch emission)
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
