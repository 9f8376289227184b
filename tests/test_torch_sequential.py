"""K9 (the sequential decoder of QOI-compat ops, color and mono): its plain
version against the JAX package's sequential compat decoder, and against
the index fixpoint.

``decode_jax.decode_stream_compat`` walks each stream's ops in a
``lax.scan`` (no Pallas kernel: its XLA form runs here on the CPU), vmapped
over a batch; the port takes the same buffers through the tokenizer and K5
(``decode_compat._ops``), K9 and K2 (``decode_compat._expand``), the path
an unsettled row takes, and every mono row. Mono streams come from
``utils.corpus.mono_qoi`` (seeded random ops, decoder-only: no encoder
writes mono .qoi) and from color .qoi encodes whose header says 1 or 2
channels. Integer codec: exact, tolerance 0.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KINDS, gen_pixels
from seqoia_tpu import native
from seqoia_tpu.codec import decode_jax
from seqoia_tpu_torch import convert
from seqoia_tpu_torch.codec import decode_compat
from seqoia_tpu_torch.ops import _build, sequential
from seqoia_tpu_torch.utils import corpus

_M, _N_MAX = 8192, 2048


def _batch(streams):
    data = np.zeros((len(streams), _M), np.uint8)
    for i, s in enumerate(streams):
        data[i, : len(s)] = np.frombuffer(s, np.uint8)
    return data, np.array([len(s) - 8 for s in streams], np.int32)


def _jax_sequential(data, clen, npx, out_ch, colch=3):
    fn = functools.partial(decode_jax.decode_stream_compat, colch=colch,
                           out_ch=out_ch, n_max=_N_MAX, max_ops=_M)
    return np.asarray(jax.vmap(fn)(jnp.asarray(data), jnp.asarray(clen),
                                   jnp.asarray(npx)))


@pytest.mark.parametrize("ch", [3, 4])
def test_sequential_decoder_matches_jax(ch):
    """Every kind of tests/conftest.py as one batch of unequal rows, plus a
    stream cut short: the port's sequential decode against the JAX one,
    and both against the native decoder."""
    rng = np.random.default_rng(950 + ch)
    shapes = [(37, 29), (41, 13), (12, 40)]
    images = []
    for i, kind in enumerate(KINDS):
        w, h = shapes[i % 3]
        images.append((gen_pixels(rng, w * h, 3 + (1 - (ch & 1)), kind), w, h))
    streams = [native.encode(p, w, h, ch, 0, 1) for p, w, h in images]
    streams.append(streams[0][: len(streams[0]) // 2] + bytes(8))
    npx = np.array([w * h for _, w, h in images] + [37 * 29], np.int32)
    data, clen = _batch(streams)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen))
    px = sequential.sequential_decode(lo, hi, totals)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    ours = decode_compat._expand(lo & 255, px, valid, convert.tensor(npx), 3,
                                 ch, _N_MAX)
    theirs = _jax_sequential(data, clen, npx, ch)
    for r, (stream, n) in enumerate(zip(streams, npx)):
        want, _ = native.decode(stream)
        assert np.array_equal(ours[r, : n * ch].numpy(), want), r
        if r < len(images):  # the JAX decoder's fill past a cut may differ
            assert np.array_equal(ours[r].numpy(), theirs[r]), r


def test_sequential_values_match_the_fixpoint():
    """Per op, K9's running pixel equals the values of the settled index
    fixpoint, on photo crops whose fixpoint settles on the card."""
    rng = np.random.default_rng(960)
    streams = [native.encode(corpus._photo(rng, 40, 40).reshape(-1), 40, 40,
                             3, 0, 1) for _ in range(2)]
    data, clen = _batch(streams)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen))
    got = sequential.sequential_decode(lo, hi, totals)
    ops = (lo & 255, (lo >> 8) & 255, (lo >> 16) & 255, (lo >> 24) & 255,
           hi & 255)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    qslot = torch.where(valid & (ops[0] < 64), ops[0], -1).to(torch.int32)
    iv = torch.zeros_like(lo)
    for _ in range(200):
        iv, stable = decode_compat._resolve(ops, valid, qslot, totals, iv)
        if bool(stable.all()):
            break
    assert bool(stable.all())
    want, _ = decode_compat._op_values(ops, iv, valid)
    assert torch.equal(torch.where(valid, want, 0), got)


def test_sequential_decode_checks_its_arguments():
    x = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        sequential.sequential_decode(x.long(), x, torch.zeros(2))
    with pytest.raises(ValueError, match="totals"):
        sequential.sequential_decode(x, x, torch.zeros(3))
    with pytest.raises(ValueError, match="device"):
        sequential.sequential_decode(x.to("meta"), x.to("meta"),
                                     torch.zeros(2))
    with pytest.raises(ValueError, match="colch"):
        sequential.sequential_decode(x, x, torch.zeros(2), colch=2)
    with pytest.raises(ValueError, match="hi"):
        sequential.sequential_decode(x, None, torch.zeros(2))
    assert torch.equal(sequential.sequential_decode(x, x, torch.zeros(2)), x)
    assert torch.equal(sequential.sequential_decode(x, None, torch.zeros(2),
                                                    colch=1), x)


def _mono_streams(rng, ch):
    """Mono .qoi rows of unequal lengths: generator streams (the default
    mix, one all INDEX and LUMA, one of long runs) and color .qoi encodes
    of conftest kinds with the header's channels byte set to ch."""
    streams = [corpus.mono_qoi(rng, 37, 29, ch),
               corpus.mono_qoi(rng, 41, 13, ch, (0.7, 0.3, 0, 0, 0)),
               corpus.mono_qoi(rng, 12, 40, ch, (0.2, 0.1, 0.6, 0.05, 0.05))]
    for kind in ("palette", "luma", "alpha_churn"):
        s = bytearray(native.encode(gen_pixels(rng, 30 * 20, 4, kind), 30, 20,
                                    4, 0, 1))
        s[12] = ch
        streams.append(bytes(s))
    return streams


def _mono_k9(streams, out_ch):
    """The port's mono route on _batch(streams): the mono tokenizer and K5,
    K9's mono step, and K2's placement and emission (_expand). Returns
    (pixels, K9's values)."""
    data, clen = _batch(streams)
    npx = np.array([int.from_bytes(s[4:8], "big")
                    * int.from_bytes(s[8:12], "big") for s in streams],
                   np.int32)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen), colch=1)
    assert hi is None
    px = sequential.sequential_decode(lo, None, totals, colch=1)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    out = decode_compat._expand(lo & 255, px, valid, convert.tensor(npx), 1,
                                out_ch, _N_MAX)
    return out, px, (data, clen, npx)


@pytest.mark.parametrize("ch", [1, 2])
def test_mono_sequential_decoder_matches_jax(ch):
    """K9's mono step (plain) against the JAX scan's mono step
    (decode_stream_compat(colch=1), vmapped) and the native decoder, at
    the header's own channel count and at 4."""
    streams = _mono_streams(np.random.default_rng(970 + ch), ch)
    for out_ch in (ch, 4):
        ours, _, (data, clen, npx) = _mono_k9(streams, out_ch)
        theirs = _jax_sequential(data, clen, npx, out_ch, colch=1)
        for r, (stream, n) in enumerate(zip(streams, npx)):
            want, _ = native.decode(stream, out_ch)
            assert np.array_equal(ours[r, : n * out_ch].numpy(), want), r
            assert np.array_equal(ours[r].numpy(), theirs[r]), r


def _op_stream(ops, w, h, ch=2):
    return (b"qoif" + w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([ch, 0]) + bytes(ops) + bytes(7) + b"\x01")


def _slot(g, a):
    return (g * 5 + a * 11) % 128


def _all_slots():
    """RGBA ops that fill all 128 slots (gray g at alpha 7 for each slot),
    then an INDEX read of every slot in a shuffled order."""
    want = {}
    ops = []
    for g in range(256):
        k = _slot(g, 7)
        if k not in want:
            want[k] = g
            ops += [0xFF, g, 7]
    assert len(want) == 128
    order = np.random.default_rng(5).permutation(128)
    ops += [int(k) for k in order]
    return ops, want, order


def test_mono_sequential_edge_rows():
    """K9's mono step at its edge rows: no op, one op, every one of the
    128 slots written and then read (an INDEX hit on a gray+alpha pixel:
    the hash is the reference's (g*5 + a*11) % 128 on gray in g, the value
    gray in byte 0), and a run to the row's end; against the JAX scan and
    the native decoder."""
    ops, want, order = _all_slots()
    streams = [
        _op_stream([], 5, 1),
        _op_stream([0xFF, 200, 17], 3, 1),
        _op_stream(ops, 2 * 128, 1),
        _op_stream([0xFE, 9, 0x85, 0xC0 + 61, 0xC0 + 40], 2 + 62 + 41, 1),
        _op_stream([0xFE, 9, 0xFD], 4, 1, ch=1),  # a run past the row's end
    ]
    ours, px, (data, clen, npx) = _mono_k9(streams, 2)
    theirs = _jax_sequential(data, clen, npx, 2, colch=1)
    for r, (stream, n) in enumerate(zip(streams, npx)):
        got = ours[r, : n * 2].numpy()
        assert np.array_equal(got, native.decode(stream, 2)[0]), r
        assert np.array_equal(ours[r].numpy(), theirs[r]), r
    # the reads of the slot-filling row: gray | alpha 7 << 24 from each slot
    n_fill = len(want)
    reads = px[2, n_fill: n_fill + 128].numpy().view(np.uint32)
    assert reads.tolist() == [want[int(k)] | 7 << 24 for k in order]
    assert ours[0, :10].tolist() == [0, 255] * 5  # no op: the initial pixel


# --- a PyTorch model of csrc/sequential.cu's design -------------------------
# Each lane pre-decodes its op into the step's operands (an INDEX slot as a
# byte offset or -1, a keep mask, a byte-wise addend); lane 0 walks a chunk
# of them with the table write of the op before still pending, each op's
# table read taken two ops ahead and the two writes it misses forwarded by
# comparing slots; past a row's end the operands are a RUN's.

_SLOTS = {1: 128, 3: 64}
_WEIGHTS = {1: (5, 0, 0, 11), 3: (3, 5, 7, 11)}  # the hash: a dot product


def _predecode(w, a, colch):
    """The step's operands of op words w (int64) and alphas a (color
    RGBA): (slot byte offset or -1, keep mask, addend), as csrc/
    sequential.cu's predecode."""
    W = torch.where
    b0, b1 = w & 255, (w >> 8) & 255
    ones = torch.full_like(w, 0xFFFFFFFF)
    zero = torch.zeros_like(w)
    if colch == 1:
        idx = b0 < 128
        add = W(b0 < 0xC0, ((b0 & 63) - 32) & 255, zero)  # LUMA (RUN: 0)
        rgb, rgba = b1, b1 | (((w >> 16) & 255) << 24)
    else:
        idx = b0 < 64
        vg = (b0 & 63) - 32
        is_diff = b0 < 0x80
        dr = W(is_diff, ((b0 >> 4) & 3) - 2, vg - 8 + (b1 >> 4))
        dg = W(is_diff, ((b0 >> 2) & 3) - 2, vg)
        db = W(is_diff, (b0 & 3) - 2, vg - 8 + (b1 & 15))
        add = W(b0 < 0xC0, (dr & 255) | ((dg & 255) << 8)
                | ((db & 255) << 16), zero)
        rgb, rgba = w >> 8, (w >> 8) | ((a & 255) << 24)
    keep = W(b0 == 0xFE, torch.full_like(w, 0xFF000000), ones)
    keep = W((b0 == 0xFF) | idx, zero, keep)
    add = W(b0 == 0xFE, rgb, W(b0 == 0xFF, rgba, add))
    add = W(idx, zero, add)
    return W(idx, b0 * 4, -1), keep, add


def _swar_add(x, y):
    """Byte-wise (x + y) mod 256, no carry across bytes."""
    return ((x & 0x7F7F7F7F) + (y & 0x7F7F7F7F)) ^ ((x ^ y) & 0x80808080)


def _slot4(v, colch):
    """The slot of value v as a byte offset (the kernel's dp4a)."""
    wts = _WEIGHTS[colch]
    dot = sum(((v >> (8 * k)) & 255) * wts[k] for k in range(4))
    return (dot * 4) & ((_SLOTS[colch] - 1) * 4)


def _model_step(v, tab, slot4, keep, add, colch):
    """One branch-free step: the value after the op, its slot offset."""
    rows = torch.arange(len(v))
    read = tab[rows, slot4.clamp(min=0) // 4]
    new = torch.where(slot4 >= 0, read, _swar_add(v & keep, add))
    return new, _slot4(new, colch)


@pytest.mark.parametrize("colch", [1, 3])
def test_predecoded_step_matches_the_plain_step(colch):
    """The pre-decoded step (operands, then the table read or the byte-wise
    sum of the kept bytes and the addend, and the dot-product hash) against
    _color_step / _mono_step at every tag 0-255, each with random running
    values, payload bytes, alphas and tables."""
    rng = np.random.default_rng(990 + colch)
    per_tag = 24
    n = 256 * per_tag
    tag = np.repeat(np.arange(256), per_tag)
    w = torch.from_numpy(tag | (rng.integers(0, 1 << 24, n) << 8))
    a = torch.from_numpy(rng.integers(0, 256, n))
    px = torch.from_numpy(rng.integers(0, 1 << 32, n))
    slots = _SLOTS[colch]
    tab = torch.from_numpy(rng.integers(0, 1 << 32, (n, slots)))
    if colch == 1:  # mono values: gray in byte 0, alpha in byte 3
        px &= 0xFF0000FF
        tab &= 0xFF0000FF
    rows = torch.arange(n)
    if colch == 1:
        want, want_slot = sequential._mono_step(px, w, tab, rows)
    else:
        want, want_slot = sequential._color_step(px, w, a, tab, rows)
    slot4, keep, add = _predecode(w, a, colch)
    got, got_slot4 = _model_step(px, tab, slot4, keep, add, colch)
    assert torch.equal(got, want)
    assert torch.equal(got_slot4, want_slot * 4)
    # the INDEX tags carry their slot, no other tag reads the table
    assert torch.equal(slot4 >= 0, torch.from_numpy(tag < slots))


def _walk_model(lo, hi, totals, colch, chunk):
    """csrc/sequential.cu's walk with ``chunk`` ops a chunk: (B, mo) int32,
    0 past each row's total."""
    bsz, mo = lo.shape
    slots = _SLOTS[colch]
    mask4 = (slots - 1) * 4
    w_all = lo.long() & 0xFFFFFFFF
    a_all = torch.zeros_like(w_all) if colch == 1 else hi.long() & 255
    out = torch.zeros((bsz, mo), dtype=torch.long)
    for r in range(bsz):
        total = min(int(totals[r]), mo)
        tab = [0] * (slots + 1)  # + the dummy slot of the first pending write
        # the value (its write pending into hp), the one before (written)
        v, hp, vp, hpp = 0xFF000000, slots * 4, 0xFF000000, slots * 4
        for c0 in range(0, total, chunk):
            j = torch.arange(c0, c0 + chunk)
            live = j < total
            jj = j.clamp(max=mo - 1)
            s4, keep, add = _predecode(w_all[r, jj], a_all[r, jj], colch)
            # past the end: a RUN's operands
            s4 = torch.where(live, s4, -1).tolist()
            keep = torch.where(live, keep, 0xFFFFFFFF).tolist()
            add = torch.where(live, add, 0).tolist()
            ahead = [tab[(s4[k] & mask4) // 4] for k in range(min(2, chunk))]
            vals = []
            for k in range(chunk):
                tab[hp // 4] = v  # op k-1's write
                if k + 2 < chunk:  # op k+2's read, two ops ahead
                    ahead.append(tab[(s4[k + 2] & mask4) // 4])
                summed = int(_swar_add(torch.tensor(v & keep[k]),
                                       torch.tensor(add[k])))
                # forward ops k-1's and k-2's writes, the later first
                read = (v if s4[k] == hp else vp if s4[k] == hpp
                        else ahead[k])
                vp, hpp = v, hp
                v = read if s4[k] >= 0 else summed
                hp = int(_slot4(torch.tensor(v), colch))
                vals.append(v)
            n = min(chunk, total - c0)
            out[r, c0: c0 + n] = torch.tensor(vals[:n])
    return convert.tensor(out.numpy().astype(np.uint32).view(np.int32))


def _walk_ops(rng, n, colch):
    """n ops (byte lists) that exercise the walk: a literal and then an
    INDEX read of its slot 1, 2, 3 or 4 ops later (the two forwarded
    writes, the table read taken ahead, the table), among random ops of
    every kind; the row starts with an RGBA op."""
    slots = _SLOTS[colch]
    wts = _WEIGHTS[colch]

    def rgba():
        if colch == 1:
            g, a = (int(x) for x in rng.integers(0, 256, 2))
            return [0xFF, g, a], (g * wts[0] + a * wts[3]) % slots
        px = [int(x) for x in rng.integers(0, 256, 4)]
        return [0xFF] + px, sum(p * q for p, q in zip(px, wts)) % slots

    def other():
        kind = rng.integers(0, 6)
        if kind == 0:
            return [int(rng.integers(0, slots))]  # INDEX
        if kind == 1:
            return [int(rng.integers(0xC0, 0xC8))]  # a short RUN
        if kind == 2:
            return [0xFE] + [int(x) for x in rng.integers(
                0, 256, 1 if colch == 1 else 3)]  # RGB
        if kind == 3:
            return rgba()[0]
        if kind == 4 and colch == 3:
            return [int(rng.integers(0x40, 0x80))]  # DIFF
        return [int(rng.integers(0x80, 0xC0))] + (
            [int(rng.integers(0, 256))] if colch == 3 else [])  # LUMA

    ops = []
    while len(ops) < n:
        if not ops:
            ops.append(rgba()[0])
            continue
        if rng.random() < 0.4:
            op, slot = rgba()
            gap = [other() for _ in range(int(rng.integers(0, 4)))]
            ops += [op] + gap + [[slot]]
        else:
            ops.append(other())
    return ops[:n]


def _walk_stream(ops, colch):
    """A .qoi stream of one row holding ``ops``, and its pixel count."""
    npx = sum((op[0] & 63) + 1 if 0xC0 <= op[0] < 0xFE else 1 for op in ops)
    body = [b for op in ops for b in op]
    ch = 2 if colch == 1 else 4
    return _op_stream(body, max(npx, 1), 1, ch=ch), npx


@pytest.mark.parametrize("chunk", [4, 7, sequential.CHUNK])
@pytest.mark.parametrize("colch", [1, 3])
def test_walk_model_matches_plain_and_jax(colch, chunk):
    """The model of the kernel's tiled walk, with ``chunk`` ops a chunk, on
    rows of 0, 1, T-1, T, T+1 and 3T+2 ops (T the chunk) and two of a few
    hundred: against sequential_decode_plain, and its pixels (K2, through
    _expand) against the JAX scan at out_ch 1-4."""
    rng = np.random.default_rng(1000 + 10 * colch + chunk)
    counts = [0, 1, chunk - 1, chunk, chunk + 1, 3 * chunk + 2, 300, 517]
    streams = [_walk_stream(_walk_ops(rng, n, colch), colch)[0]
               for n in counts]
    data, clen = _batch(streams)
    lo, hi, totals = decode_compat._ops(torch.from_numpy(data),
                                        convert.tensor(clen), colch=colch)
    assert totals.tolist() == counts
    got = _walk_model(lo, hi, totals, colch, chunk)
    assert torch.equal(got, sequential.sequential_decode_plain(
        lo, hi, totals, colch))
    npx = np.array([int.from_bytes(s[4:8], "big") for s in streams], np.int32)
    valid = torch.arange(lo.shape[1])[None, :] < totals[:, None]
    for out_ch in (1, 2, 3, 4):
        ours = decode_compat._expand(lo & 255, got, valid, convert.tensor(npx),
                                     colch, out_ch, _N_MAX)
        theirs = _jax_sequential(data, clen, npx, out_ch, colch=colch)
        assert np.array_equal(ours.numpy(), theirs), out_ch


def test_walk_geometry_names_the_kernel_source():
    """ops/sequential.py's CHUNK and RING (which chip_smoke.py's edge totals
    read) are csrc/sequential.cu's LANES and STAGES."""
    with open(os.path.join(_build.CSRC, "sequential.cu")) as f:
        src = f.read()
    found = dict(re.findall(r"constexpr int (LANES|STAGES) = (\d+);", src))
    assert found == {"LANES": str(sequential.CHUNK),
                     "STAGES": str(sequential.RING)}
