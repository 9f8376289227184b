"""The QOI-compat (.qoi) slice of the port on the CPU (the kernels' plain
versions): the fixpoint decode and the compat encode against the JAX
package with its Pallas kernels in interpret mode, and the public
encode/decode against seqoia_tpu, the native oracle and, where it is
mounted, the upstream reference probe. Integer codec: exact, tolerance 0.

The interpret-mode subprocess runs ``decode_compat.
decode_stream_compat_batched`` (K8 tokenizer and segmod, K5, K7, K6) and
the compat branch of ``encode_v2.encode_stream_batched`` (K8 max, K7, K5,
K6) on buffers of 32768 entries, the TPU's tile; the port takes the same
buffers. The JAX fixpoint's pixels are held only on the rows it settles:
it leaves the others to its host decoder, while the port settles them on
the card, so those are held against the native decoder.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import seqoia_tpu as sq
import seqoia_tpu_torch as st
from conftest import KINDS, gen_pixels
from seqoia_tpu import native
from seqoia_tpu_torch import convert, spec
from seqoia_tpu_torch.codec import (decode_stream_compat_batched,
                                    encode_stream_batched)
from seqoia_tpu_torch.codec import decode_compat
from seqoia_tpu_torch.codec.encode import normalize_pixels_packed
from seqoia_tpu_torch.utils import corpus

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_M = 32768

_SCRIPT = r"""
import os, sys
os.environ["SEQOIA_PALLAS_INTERPRET"] = "1"
os.environ.pop("SEQOIA_FIXPOINT_ITERS", None)
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from seqoia_tpu.codec import decode_compat, encode_v2

inp = np.load(sys.argv[1])
out = {}
for name in [str(n) for n in inp["dec_names"]]:
    g = lambda k: jnp.asarray(inp[name + "/" + k])
    px, conv = decode_compat.decode_stream_compat_batched(
        g("data"), g("clen"), g("npx"), colch=3,
        out_ch=int(inp[name + "/out_ch"]), n_max=int(inp[name + "/n_max"]))
    out[name + "/px"] = np.asarray(px)
    out[name + "/conv"] = np.asarray(conv)
enc, total = encode_v2.encode_stream_batched(
    jnp.asarray(inp["enc/packed"]), jnp.asarray(inp["enc/nv"]), colch=3,
    has_alpha=True, compat=True, out_cap=int(inp["enc/cap"]))
out["enc/out"] = np.asarray(enc)
out["enc/total"] = np.asarray(total)
np.savez(sys.argv[2], **out)
print("PALLAS-OK")
"""


def _chain_pixels():
    """The 61-link INDEX chain of tests/test_compat_fixpoint.py: color A
    hashes to slot 0, where the fixpoint's wrong guesses land too, and
    alternates with unique fillers, so each repeat of A reads the previous
    INDEX-decoded A and the fixpoint advances one link per pass."""
    a = (25, 0, 0, 255)
    pixels = [a]
    for c in range(2, 64):
        if c == 43:  # this filler would hash to slot 0
            continue
        pixels += [(c, 40, 0, 255), a]
    return np.array(pixels, np.uint8).reshape(-1), len(pixels)


def _rows(streams):
    data = np.zeros((len(streams), _M), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    return data, np.array([len(s) - 8 for s in streams], np.int32)


def _dec_case(images, out_ch, n_max):
    streams = [native.encode(p, w, h, ch, 0, 1) for p, w, h, ch in images]
    data, clen = _rows(streams)
    return dict(data=data, clen=clen, out_ch=out_ch, n_max=n_max,
                npx=np.array([w * h for _, w, h, _ in images], np.int32))


def _inputs():
    rng = np.random.default_rng(51)
    chain, n_chain = _chain_pixels()
    dec = {
        "shallow": _dec_case(
            [(gen_pixels(rng, 64 * 64, 4, "palette"), 64, 64, 4)], 4, 4096),
        "chain": _dec_case([(chain, n_chain, 1, 4)], 4, 2048),
        "batch3": _dec_case(
            [(gen_pixels(rng, 40 * 30, 3, "sparse_delta"), 40, 30, 3),
             (gen_pixels(rng, 64 * 50, 3, "palette"), 64, 50, 3),
             (gen_pixels(rng, 17 * 9, 3, "luma"), 17, 9, 3)], 3, 4096),
        # a crop of the photo class chip_smoke.py drives at full size
        "photo": _dec_case(
            [(corpus._photo(rng, 96, 96).reshape(-1), 96, 96, 3)], 3, 16384),
    }
    # a .qoi cut to its first third (its end marker re-appended)
    whole = native.encode(gen_pixels(rng, 64 * 64, 4, "luma"), 64, 64, 4, 0, 1)
    data, clen = _rows([whole[: len(whole) // 3] + bytes(8)])
    dec["truncated"] = dict(data=data, clen=clen, out_ch=4, n_max=4096,
                            npx=np.array([64 * 64], np.int32))
    # encode: a palette row that starts with a first-seen (0, 0, 0, 0) (an
    # index hit against the zeroed table) and an opaque row with runs
    pal = gen_pixels(rng, _M, 4, "palette").reshape(-1, 4)
    pal[:3] = 0
    runs = gen_pixels(rng, 20000, 3, "long_runs")
    packed = np.stack([
        normalize_pixels_packed(pal.reshape(-1), spec.SqoaDesc(_M, 1, 4)),
        np.pad(normalize_pixels_packed(runs, spec.SqoaDesc(20000, 1, 3)),
               (0, _M - 20000))])
    enc = dict(packed=packed, nv=np.array([_M, 20000], np.int32),
               cap=np.int32(spec.cap_bucket(_M * 5 + 9)))
    return dec, enc


DEC, ENC = _inputs()


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("compat")
    arrays = {"dec_names": np.array(list(DEC))}
    for name, c in DEC.items():
        for k, v in c.items():
            arrays[f"{name}/{k}"] = np.asarray(v)
    for k, v in ENC.items():
        arrays["enc/" + k] = np.asarray(v)
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, cwd=_ROOT, capture_output=True, text=True, timeout=600)
    assert "PALLAS-OK" in res.stdout, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def test_tokenize_matches_jax():
    """The compat tokenizer (K8's map composition) against the JAX
    package's on the CPU, over the batch3 and truncated buffers."""
    import jax.numpy as jnp

    from seqoia_tpu.codec import decode_v2 as jax_decode_v2
    from seqoia_tpu_torch.codec import decode_v2

    for name in ("batch3", "truncated"):
        c = DEC[name]
        b = c["data"].astype(np.int32)
        clen = c["clen"][:, None]
        want, _ = jax_decode_v2._tokenize(jnp.asarray(b), jnp.asarray(clen),
                                          3, True)
        got = decode_v2._tokenize(torch.from_numpy(b), torch.from_numpy(clen))
        assert np.array_equal(got.numpy(), np.asarray(want)), name


@pytest.mark.parametrize("name", ["shallow", "chain", "batch3", "photo"])
def test_fixpoint_matches_pallas(name, pallas_out):
    c = DEC[name]
    stats = {}
    px, conv = decode_stream_compat_batched(
        torch.from_numpy(c["data"]), convert.tensor(c["clen"]),
        convert.tensor(c["npx"]), colch=3, out_ch=c["out_ch"],
        n_max=c["n_max"], stats=stats)
    assert conv.tolist() == pallas_out[name + "/conv"].tolist()
    # the palette row of batch3 and the photo chain too deep as well (the
    # probe's strict depth is above 12); the others settle
    want_conv = {"shallow": [True], "chain": [False],
                 "batch3": [True, False, True], "photo": [False]}[name]
    assert conv.tolist() == want_conv
    if all(want_conv):
        assert 1 < stats["passes"] < decode_compat._MAX_ITERS
    else:
        assert stats["passes"] == decode_compat._MAX_ITERS
    assert stats["settled_rows"] == want_conv.count(False)
    assert (stats["settle_passes"] > 0) == (False in want_conv)
    assert stats["sequential_rows"] == 0
    for r, n in enumerate(c["npx"]):
        stream = bytes(c["data"][r, : c["clen"][r] + 8])
        want, _ = native.decode(stream)
        assert np.array_equal(px[r, : n * c["out_ch"]].numpy(), want)
        if want_conv[r]:
            assert np.array_equal(px[r].numpy(), pallas_out[name + "/px"][r])
        else:
            assert st.native.compat_probe(stream)[4] > decode_compat._MAX_ITERS


def test_compat_encode_matches_pallas(pallas_out):
    out, total = encode_stream_batched(
        convert.tensor(ENC["packed"]), convert.tensor(ENC["nv"]), colch=3,
        out_cap=int(ENC["cap"]), compat=True)
    assert total.tolist() == pallas_out["enc/total"].tolist()
    assert np.array_equal(out.numpy(), pallas_out["enc/out"])
    # the first (0, 0, 0, 0) pixel is an INDEX op of slot 0
    assert out[0, 0] == 0


def _stride(ch):
    return 3 + (1 - (ch & 1))


_SHAPES = [(37, 29), (61, 13)]


@pytest.mark.parametrize("ch", [3, 4])
def test_qoi_encode_matches_jax_and_native(ch):
    rng = np.random.default_rng(600 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        d = st.SqoaDesc(w, h, ch, i % 2, 1)
        ours = st.encode(pix, d, device="cpu")
        assert ours == native.encode(pix, w, h, ch, d.colorspace, 1), kind
        assert ours == sq.encode(pix, sq.SqoaDesc(w, h, ch, i % 2, 1)), kind


@pytest.mark.parametrize("ch", [3, 4])
def test_qoi_decode_matches_jax_and_native(ch):
    rng = np.random.default_rng(700 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        stream = native.encode(gen_pixels(rng, w * h, _stride(ch), kind),
                               w, h, ch, 0, 1)
        for fch in (0, 1, 2, 3, 4):
            ours, desc = st.decode(stream, fch, device="cpu")
            want, wdesc = native.decode(stream, fch)
            assert np.array_equal(ours, want), (kind, fch)
            assert (desc.width, desc.height, desc.channels, desc.colorspace,
                    desc.qoi_compat) == wdesc
            if i == 0:  # the JAX path compiles per shape and channel count
                assert np.array_equal(ours, sq.decode(stream, fch)[0])


@pytest.mark.parametrize("ch", [3, 4])
def test_qoi_codec_matches_reference_probe(ch, refprobe):
    rng = np.random.default_rng(800 + ch)
    for i, kind in enumerate(KINDS):
        w, h = _SHAPES[i % 2]
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        stream = st.encode(pix, st.SqoaDesc(w, h, ch, 0, 1), device="cpu")
        assert stream == refprobe.encode(pix, w, h, ch, 0, 1), kind
        for fch in (0, 1, 2, 3, 4):
            ours, _ = st.decode(stream, fch, device="cpu")
            assert np.array_equal(ours, refprobe.decode(stream, fch)[0])


def test_truncated_qoi_fills_to_the_end(pallas_out):
    """A .qoi cut short fills the pixels it does not reach with the last
    value, as the reference does (seqoia.h:722-726), in the fixpoint and in
    the public decode. The JAX fixpoint's Pallas expansion bounds its fill
    (max_gap = 61, decode_compat.py:207), so it stops filling before the
    end: a fault of the JAX reference (ROADMAP.md Queue 3), which the port
    does not copy."""
    c = DEC["truncated"]
    cut = bytes(c["data"][0, : c["clen"][0] + 8])
    want, _ = native.decode(cut, 0)
    px, conv = decode_stream_compat_batched(
        torch.from_numpy(c["data"]), convert.tensor(c["clen"]),
        convert.tensor(c["npx"]), colch=3, out_ch=4, n_max=4096)
    assert conv.tolist() == [True]
    assert np.array_equal(px[0].numpy(), want)
    assert np.array_equal(st.decode(cut, 0, device="cpu")[0], want)
    jax_px = pallas_out["truncated/px"][0]
    diff = np.nonzero(jax_px != want)[0]
    assert len(diff) and np.array_equal(jax_px[: diff[0]], want[: diff[0]])
    # the last op is at pixel 1358; the JAX output leaves the fill at 1536
    assert diff[0] // 4 == 1536


def test_unconverged_qoi_settles_on_the_card(monkeypatch):
    """A stream the fixpoint does not settle in 12 passes still decodes
    exactly through the card path: the public decode never calls the host
    decoder for a .qoi stream."""
    dec_mod = importlib.import_module("seqoia_tpu_torch.codec.decode")

    def host(*a):
        raise AssertionError("a .qoi stream went to the host decoder")

    monkeypatch.setattr(dec_mod, "_host", host)
    monkeypatch.setattr(st.native, "decode", host)
    chain, n = _chain_pixels()
    stream = native.encode(chain, n, 1, 4, 0, 1)
    ours, desc = st.decode(stream, 3, device="cpu")
    assert np.array_equal(ours, chain.reshape(-1, 4)[:, :3].reshape(-1))
    assert desc.qoi_compat == 1


def _value_chain(links):
    """Each INDEX op reads the value a DIFF op derived from the INDEX op
    before it, so neither the zero guesses nor the speculated alpha help:
    the fixpoint settles one link per pass."""
    def slot(c):
        return (c[0] * 3 + c[1] * 5 + c[2] * 7 + c[3] * 11) % 64

    px = [(0, 40, 0, 255)]
    for i in range(1, links + 1):
        x, z = (i, 40, 0, 255), (0, 200, i, 255)
        if slot(z) == slot(x):  # the filler would evict x from the index
            z = (0, 201, i, 255)
        px += [x, z, x]
    return np.array(px, np.uint8).reshape(-1), len(px)


@pytest.mark.parametrize("links", [20, 100])
def test_a_value_chain_ends_in_the_sequential_decoder(links):
    """A chain of dependent INDEX reads (the probe's strict depth) settles
    one link per pass; the restart stops after _SETTLE_ITERS passes and
    hands a row still unsettled to K9, so the row costs a bounded number of
    passes. A chain short enough settles in the restart."""
    pixels, n = _value_chain(links)
    stream = native.encode(pixels, n, 1, 4, 0, 1)
    assert st.native.compat_probe(stream)[4] == links
    data, clen = _rows([stream])
    stats = {}
    px, conv = decode_stream_compat_batched(
        torch.from_numpy(data), convert.tensor(clen), torch.tensor([n]),
        colch=3, out_ch=4, n_max=512, stats=stats)
    assert conv.tolist() == [False]
    assert np.array_equal(px[0, : n * 4].numpy(), pixels)
    assert stats["passes"] == decode_compat._MAX_ITERS
    if links + 1 <= decode_compat._MAX_ITERS + decode_compat._SETTLE_ITERS:
        # one resolution per link and one to see it stable
        assert stats["settle_passes"] == links + 1 - decode_compat._MAX_ITERS
        assert stats["sequential_rows"] == 0
    else:
        assert stats["settle_passes"] == decode_compat._SETTLE_ITERS
        assert stats["sequential_rows"] == 1


def test_compat_probe_matches_jax():
    """The port's copy of the chain-depth probe against the JAX package's
    on every kind and both color modes; SQOA and mono streams give None."""
    rng = np.random.default_rng(900)
    for i, kind in enumerate(KINDS):
        for ch in (3, 4):
            w, h = _SHAPES[i % 2]
            pix = gen_pixels(rng, w * h, _stride(ch), kind)
            qoi = native.encode(pix, w, h, ch, 0, 1)
            assert st.native.compat_probe(qoi) == native.compat_probe(qoi)
            assert st.native.compat_probe(
                native.encode(pix, w, h, ch, 0, 0)) is None
    mono = native.encode(gen_pixels(rng, 64, 1, "noise"), 8, 8, 1, 0, 0)
    assert st.native.compat_probe(mono) is None


@pytest.mark.parametrize("call,ch", [
    ("encode", 3), ("encode", 4), ("encode qoi", 3), ("encode qoi", 4),
    ("encode_large", 3), ("encode_large", 4),
    ("encode_large_shardmap 1", 3), ("encode_large_shardmap 4", 3)])
def test_one_front_and_one_k2_per_encode(call, ch, monkeypatch):
    """Every encode call runs K2 once, sized from the exact totals its front
    computes before it (no retry at a larger cap), and a SQOA call runs K3
    once (a .qoi call none: its front is torch ops, K5, K7 and K8); the
    bytes equal native.encode. Integer codec: exact."""
    from seqoia_tpu_torch.ops import encode_front, engine

    calls = {"K2": 0, "K3": 0}

    def counted(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(engine, "place_emit",
                        counted("K2", engine.place_emit))
    monkeypatch.setattr(encode_front, "encode_front_compact",
                        counted("K3", encode_front.encode_front_compact))
    rng = np.random.default_rng(62 + ch)
    w, h = 61, 37  # off every tile and bucket
    qoi = call == "encode qoi"
    pix = gen_pixels(rng, w * h, _stride(ch), "long_runs" if ch == 4
                     else "noise")
    desc = st.SqoaDesc(w, h, ch, 0, int(qoi))
    if call.startswith("encode_large_shardmap"):
        got = st.encode_large_shardmap(pix, desc, n_shards=int(call[-1]),
                                       device="cpu")
    elif call == "encode_large":
        got = st.encode_large(pix, desc, device="cpu")
    else:
        got = st.encode(pix, desc, device="cpu")
    assert got == native.encode(pix, w, h, ch, 0, int(qoi))
    assert calls == {"K2": 1, "K3": 0 if qoi else 1}


@pytest.mark.parametrize("ch", [3, 4])
def test_qoi_encode_emits_through_k2(ch, monkeypatch):
    """The .qoi encode's bytes come from one place_emit with the compat
    epilogue (EPI_ENCQ's plain version on the CPU), with no K6 spread: one
    row per conftest kind in one batched call, its bytes equal to the JAX
    package's encode_stream_batched(compat=True) and to native.encode.
    Integer codec: exact."""
    import jax.numpy as jnp

    from seqoia_tpu.codec import encode_v2 as jax_encode_v2
    from seqoia_tpu_torch.ops import engine

    rng = np.random.default_rng(900 + ch)
    n = 4096
    shapes = [(64, 64), (50, 41), (33, 17), (64, 63), (1, 1), (40, 40)]
    rows, nv, streams = [], [], []
    for kind, (w, h) in zip(KINDS, shapes):
        pix = gen_pixels(rng, w * h, _stride(ch), kind)
        rows.append(np.pad(normalize_pixels_packed(
            pix, spec.SqoaDesc(w, h, ch, 0, 1)), (0, n - w * h)))
        nv.append(w * h)
        streams.append(native.encode(pix, w, h, ch, 0, 1))
    packed, nv = np.stack(rows), np.array(nv, np.int32)
    cap = spec.cap_bucket(n * 5 + 9)

    kinds = []
    emit = engine.place_emit
    monkeypatch.setattr(engine, "place_emit", lambda *a: kinds.append(
        a[-1].kind) or emit(*a))
    monkeypatch.setattr(engine, "place_fill", None)  # no spread may remain
    out, total = encode_stream_batched(
        convert.tensor(packed), convert.tensor(nv), colch=3, out_cap=cap,
        compat=True)
    assert kinds == [engine.EPI_ENCQ]
    want, want_total = jax_encode_v2.encode_stream_batched(
        jnp.asarray(packed), jnp.asarray(nv), colch=3, has_alpha=ch == 4,
        compat=True, out_cap=cap)
    assert total.tolist() == np.asarray(want_total).tolist()
    assert np.array_equal(out.numpy(), np.asarray(want))
    for i, (kind, stream) in enumerate(zip(KINDS, streams)):
        assert out[i, : total[i]].numpy().tobytes() == stream[14:], kind


def _mono_qoi_streams(rng, ch):
    """Mono .qoi streams: corpus.mono_qoi's seeded ops and a color .qoi
    encode whose header's channels byte says ch."""
    s = bytearray(native.encode(gen_pixels(rng, 37 * 29, 4, "palette"), 37,
                                29, 4, 0, 1))
    s[12] = ch
    return [corpus.mono_qoi(rng, 61, 13, ch), bytes(s)]


def test_tokenize_mono_matches_jax():
    """The mono tokenizer (RGB 2 bytes, RGBA 3, every other tag 1) against
    the JAX package's on the CPU."""
    import jax.numpy as jnp

    from seqoia_tpu.codec import decode_v2 as jax_decode_v2
    from seqoia_tpu_torch.codec import decode_v2

    streams = _mono_qoi_streams(np.random.default_rng(980), 2)
    data, clen = _rows(streams)
    b = data.astype(np.int32)
    want, _ = jax_decode_v2._tokenize(jnp.asarray(b),
                                      jnp.asarray(clen[:, None]), 1, True)
    got = decode_v2._tokenize(torch.from_numpy(b),
                              torch.from_numpy(clen[:, None]), 1)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ch", [1, 2])
def test_mono_qoi_decode_matches_jax_and_native(ch):
    """Mono .qoi through the public decode at channels 0-4 against the
    native decoder (and the JAX package's decode at the stored count), and
    the batched call: every row by K9, no fixpoint pass."""
    streams = _mono_qoi_streams(np.random.default_rng(990 + ch), ch)
    for stream in streams:
        for fch in (0, 1, 2, 3, 4):
            ours, desc = st.decode(stream, fch, device="cpu")
            want, wdesc = native.decode(stream, fch)
            assert np.array_equal(ours, want), fch
            assert (desc.width, desc.height, desc.channels, desc.colorspace,
                    desc.qoi_compat) == wdesc
        assert np.array_equal(st.decode(stream, device="cpu")[0],
                              sq.decode(stream)[0])
    data, clen = _rows(streams)
    npx = [61 * 13, 37 * 29]
    stats = {}
    px, conv = decode_stream_compat_batched(
        torch.from_numpy(data), convert.tensor(clen), torch.tensor(npx),
        colch=1, out_ch=ch, n_max=2048, stats=stats)
    assert conv.tolist() == [True, True]
    assert stats == dict(passes=0, settled_rows=0, settle_passes=0,
                         sequential_rows=2)
    for r, stream in enumerate(streams):
        want, _ = native.decode(stream)
        assert np.array_equal(px[r, : npx[r] * ch].numpy(), want)


def test_mono_and_color_qoi_in_one_batch_decoder():
    """BatchDecoder with mono and color .qoi streams (and SQOA) mixed:
    every class on the card path, no row on the host, pixels equal to the
    native decoder's at the stored channels and at 3."""
    rng = np.random.default_rng(995)
    streams = (_mono_qoi_streams(rng, 1) + _mono_qoi_streams(rng, 2)
               + [corpus.mono_qoi(rng, 61, 13, 2),
                  native.encode(gen_pixels(rng, 40 * 30, 4, "luma"), 40, 30,
                                4, 0, 1),
                  native.encode(gen_pixels(rng, 40 * 30, 3, "palette"), 40,
                                30, 3, 0, 1),
                  native.encode(gen_pixels(rng, 40 * 30, 2, "luma"), 40, 30,
                                2, 0, 0)])
    dec = st.BatchDecoder(device="cpu")
    for channels in (0, 3):
        res = dec(streams, channels)
        for r, stream in zip(res, streams):
            want, _ = native.decode(stream, channels)
            assert r.error is None and np.array_equal(r.pixels, want)
        assert dec.last_stats["host_rows"] == 0
