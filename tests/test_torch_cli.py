"""The port's tooling layer (``seqoia_tpu_torch.cli``, ``io/png.py``,
``utils/bench_harness.py``): the cases of ``tests/test_cli.py`` through the
port's CLI, with ``--native`` and on the card path's plain versions
(``--device cpu``), byte-equal to ``seqoia_tpu.cli --native``; and the
numpy PNG reader against PIL's decoder on every filter type and colour
type 0/2/4/6.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest

from seqoia_tpu import cli as jax_cli
from seqoia_tpu_torch import cli, native
from seqoia_tpu_torch.io import png as pngio
from seqoia_tpu_torch.utils import bench_harness, make_corpus

_PATHS = (["--native"], ["--device", "cpu"])


def _write_png(path, w, h, ch, seed=0):
    rng = np.random.default_rng(seed)
    # plateau-ish content so the encode paths see runs as well as deltas
    base = rng.integers(0, 256, (h, 1, ch), dtype=np.uint8)
    pix = np.broadcast_to(base, (h, w, ch)).copy()
    pix[:, w // 2:, :] = rng.integers(0, 256, (h, w - w // 2, ch),
                                      dtype=np.uint8)
    pngio.write_image(path, pix.reshape(-1), w, h, ch)
    return pix.reshape(-1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("path", _PATHS, ids=("native", "cpu"))
def test_convert_png_sqoa_roundtrip(tmp_path, path):
    src = str(tmp_path / "in.png")
    mid = str(tmp_path / "mid.sqoa")
    back = str(tmp_path / "out.png")
    pix = _write_png(src, 20, 13, 3)

    assert cli.main(["convert", *path, src, mid]) == 0
    # odd-channel input gains an alpha plane at encode: force RGB out
    got, desc = native.decode(_read(mid), 3)
    assert (desc[0], desc[1]) == (20, 13)
    assert np.array_equal(got, pix)

    assert cli.main(["convert", *path, mid, back]) == 0
    rt, w, h, ch = pngio.read_image(back)
    assert (w, h, ch) == (20, 13, 4)
    rt = rt.reshape(-1, 4)
    assert np.array_equal(rt[:, :3].reshape(-1), pix)
    assert np.all(rt[:, 3] == 255)


@pytest.mark.parametrize("path", _PATHS, ids=("native", "cpu"))
def test_convert_qoi_extension_sets_compat(tmp_path, path):
    src = str(tmp_path / "in.png")
    out = str(tmp_path / "out.qoi")
    _write_png(src, 16, 16, 4, seed=1)
    assert cli.main(["convert", *path, src, out]) == 0
    data = _read(out)
    assert data[:4] == b"qoif"  # compat: the qoif magic, no start byte
    pix, desc = native.decode(data, 0)
    assert pix is not None and desc[4] == 1


@pytest.mark.parametrize("path", _PATHS, ids=("native", "cpu"))
def test_convert_odd_channels_forced_even(tmp_path, path):
    src = str(tmp_path / "gray.png")
    out = str(tmp_path / "out.sqoa")
    _write_png(src, 9, 7, 1, seed=2)
    assert cli.main(["convert", *path, src, out]) == 0
    _, desc = native.decode(_read(out), 0)
    assert desc[2] == 2  # gray + alpha


def test_convert_jpeg_output(tmp_path):
    pytest.importorskip("PIL")
    src = str(tmp_path / "in.png")
    out = str(tmp_path / "out.jpg")
    _write_png(src, 24, 18, 3, seed=3)
    assert cli.main(["convert", "--native", src, out]) == 0
    pix, w, h, ch = pngio.read_image(out)
    assert (w, h, ch) == (24, 18, 3)


def test_jpeg_output_needs_pil(tmp_path, monkeypatch):
    monkeypatch.setattr(pngio, "_HAVE_PIL", False)
    with pytest.raises(RuntimeError, match="PIL"):
        pngio.write_image(str(tmp_path / "x.jpg"), np.zeros(12, np.uint8),
                          2, 2, 3)


@pytest.mark.parametrize("path", _PATHS, ids=("native", "cpu"))
def test_convert_rejects_unknown_extensions(tmp_path, path):
    src = str(tmp_path / "in.png")
    _write_png(src, 8, 8, 3)
    assert cli.main(["convert", *path, src, str(tmp_path / "x.gif")]) == 1
    bmp = str(tmp_path / "x.bmp")
    with open(bmp, "wb") as f:
        f.write(b"BM" + b"\0" * 64)
    assert cli.main(["convert", *path, bmp, "out.sqoa"]) == 1


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_convert_writes_the_jax_clis_bytes(tmp_path, ch):
    """One command line, three runs: the JAX CLI with --native, the port's
    with --native and on its card path's plain versions. The same .sqoa
    and .qoi bytes, the same PNG pixels back; mono .qoi refused alike."""
    src = str(tmp_path / "in.png")
    _write_png(src, 23, 11, ch, seed=10 + ch)
    for ext in (".sqoa", ".qoi"):
        outs, rcs = [], []
        for tag, run, args in (("jax", jax_cli.main, ["--native"]),
                               ("nat", cli.main, ["--native"]),
                               ("cpu", cli.main, ["--device", "cpu"])):
            out = str(tmp_path / f"{tag}{ext}")
            rcs.append(run(["convert", *args, src, out]))
            if rcs[-1] == 0:
                back = str(tmp_path / f"{tag}{ext}.png")
                assert run(["convert", *args, out, back]) == 0
                outs.append((_read(out), pngio.read_image(back)))
        assert len(set(rcs)) == 1, rcs
        assert rcs[0] == (1 if ext == ".qoi" and ch < 3 else 0)
        for data, (px, w, h, c) in outs[1:]:
            assert data == outs[0][0]
            assert np.array_equal(px, outs[0][1][0])
            assert (w, h, c) == outs[0][1][1:]


def test_bench_harness_directory(tmp_path, capsys):
    d = tmp_path / "suite" / "sub"
    os.makedirs(d)
    for i in range(3):
        _write_png(str(d / f"img_{i}.png"), 12 + i, 10, 3, seed=i)
    rc = cli.main(["bench", "--nopng", str(tmp_path / "suite"), "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "decode mpps" in out and "sqoa" in out and "qoi" in out
    assert "# Grand total" in out


def test_bench_harness_flags(tmp_path, capsys):
    d = tmp_path / "suite"
    os.makedirs(d)
    _write_png(str(d / "img.png"), 10, 10, 4, seed=5)
    rc = cli.main([
        "bench", "--nopng", "--nodecode", "--onlytotals", "--nowarmup",
        str(d), "1",
    ])
    assert rc == 0
    assert "# Grand total" in capsys.readouterr().out


def test_bench_cuda_row_on_the_plain_versions(tmp_path, capsys):
    """`bench --cuda --device cpu`: the card path's row (sqoa:cuda) beside
    png, qoi and sqoa; its size is the native stream's."""
    d = tmp_path / "suite"
    os.makedirs(d)
    for i in range(2):
        _write_png(str(d / f"img_{i}.png"), 16, 9, 3 + i, seed=i)
    assert cli.main(["bench", "--cuda", "--device", "cpu", str(d), "1"]) == 0
    out = capsys.readouterr().out
    assert "sqoa:cuda" in out and "png" in out
    grand = bench_harness.bench_directory(str(d), runs=1, use_cuda=True,
                                          device="cpu")
    assert grand.count == 2
    assert grand.size["sqoa:cuda"] == grand.size["sqoa"]
    assert set(grand.size) == {"png", "qoi", "sqoa", "sqoa:cuda"}


def test_bench_gray_images_have_no_qoi_row(tmp_path):
    """The encoder refuses mono .qoi, so a gray image gets no qoi row (the
    JAX harness fails there on len(None): ROADMAP, Queue 3)."""
    d = tmp_path / "suite"
    os.makedirs(d)
    _write_png(str(d / "gray.png"), 14, 9, 1, seed=4)
    _write_png(str(d / "ga.png"), 14, 9, 2, seed=5)
    _write_png(str(d / "rgb.png"), 14, 9, 3, seed=6)
    grand = bench_harness.bench_directory(str(d), runs=1,
                                          opts={"nopng": True})
    assert grand.count == 3
    rgb = pngio.read_image(str(d / "rgb.png"))[0].reshape(-1, 3)
    rgba = np.concatenate([rgb, np.full((len(rgb), 1), 255, np.uint8)], 1)
    assert grand.size["qoi"] == len(native.encode(rgba, 14, 9, 4, 0, 1))
    assert (grand.codec_px["qoi"], grand.codec_px["sqoa"]) == (126, 378)


def test_time_loop_discards_the_warmup_run():
    calls = []
    bench_harness._time_loop(lambda: calls.append(1), 3, False)
    assert len(calls) == 4
    bench_harness._time_loop(lambda: calls.append(1), 3, True)
    assert len(calls) == 7


def test_corpus_command(tmp_path):
    d = str(tmp_path / "corpus")
    assert cli.main(["corpus", d, "--scale", "0.05"]) == 0
    files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    assert len(files) == len(make_corpus(0.05))
    pix, w, h, ch = pngio.read_image(os.path.join(d, files[0]))
    assert pix.size == w * h * ch
    assert np.array_equal(pix, make_corpus(0.05)[0][0])


@pytest.mark.parametrize("path", ([], ["--cuda", "--device", "cpu"]),
                         ids=("native", "cpu"))
def test_fuzz_command(path, capsys):
    assert cli.main(["fuzz", "60", "--seed", "7", *path]) == 0
    assert "0 mismatches" in capsys.readouterr().out


# -- the numpy PNG codec ---------------------------------------------------

def _filtered_png(img, filters):
    """A PNG of img (h, w, c) whose row y is filtered with filters[y]
    (None, Sub, Up, Avg, Paeth), written here, since PIL chooses its own
    filters and never chooses Avg."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    raw = []
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int32)
        a = np.concatenate([np.zeros(c, np.int32), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        ft = filters[y]
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (a + up) >> 1
        else:
            pa, pb, pc = np.abs(up - ul), np.abs(a - ul), np.abs(a + up
                                                                  - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, ul))
        raw.append(bytes([ft]) + ((x - pred) & 255).astype(np.uint8).tobytes())

    def chunk(t, p):
        return (struct.pack(">I", len(p)) + t + p
                + struct.pack(">I", zlib.crc32(t + p) & 0xFFFFFFFF))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(raw)))
            + chunk(b"IEND", b""))


def _filter_types(data):
    pos, idat, w, h, c = 8, b"", 0, 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        if data[pos + 4: pos + 8] == b"IHDR":
            w, h, _, t = struct.unpack(">IIBB", data[pos + 8: pos + 18])
            c = {0: 1, 2: 3, 4: 2, 6: 4}[t]
        elif data[pos + 4: pos + 8] == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * c + 1)[:, 0].tolist())


def _varied(rng, h, w, c):
    """Rows that make a filtering encoder choose among its filters: noise,
    ramps, copies of the row above, planes."""
    img = np.zeros((h, w, c), np.int32)
    xx = np.arange(w)[:, None]
    for y in range(h):
        k = y % 4
        if k == 0:
            img[y] = rng.integers(0, 256, (w, c))
        elif k == 1:
            img[y] = xx * 7 + rng.integers(0, 2, (w, c))
        elif k == 2:
            img[y] = img[y - 1] + rng.integers(0, 2, (w, c))
        else:
            img[y] = img[y - 1] + (xx * 3) % 256 - ((xx - 1) * 3) % 256 + 13
    return (img & 255).astype(np.uint8)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_numpy_png_reader_matches_pil(tmp_path, monkeypatch, c):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(c)
    img = _varied(rng, 40, 37, c)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[c]
    by_pil = tmp_path / "pil.png"
    pil.fromarray(img.squeeze(2) if c == 1 else img, mode).save(by_pil)
    by_hand = tmp_path / "hand.png"
    by_hand.write_bytes(_filtered_png(img, [y % 5 for y in range(40)]))
    seen = _filter_types(by_pil.read_bytes())
    assert {1, 2, 4} <= seen  # PIL's own choice: Sub, Up, Paeth at least
    assert _filter_types(by_hand.read_bytes()) == {0, 1, 2, 3, 4}
    for path in (by_pil, by_hand):
        want = np.asarray(pil.open(path)).reshape(-1)
        assert np.array_equal(want, img.reshape(-1))
        monkeypatch.setattr(pngio, "_HAVE_PIL", False)
        px, w, h, ch = pngio.read_image(str(path))
        monkeypatch.setattr(pngio, "_HAVE_PIL", True)
        assert (w, h, ch) == (37, 40, c)
        assert np.array_equal(px, want)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_numpy_png_writer_reads_back(tmp_path, monkeypatch, c):
    """Without PIL: written with filter None, read back by the numpy reader
    and by PIL, the JAX package's fallback writer's bytes."""
    from seqoia_tpu.io import png as jax_png

    img = _varied(np.random.default_rng(10 + c), 9, 13, c)
    monkeypatch.setattr(pngio, "_HAVE_PIL", False)
    path = str(tmp_path / "np.png")
    pngio.write_image(path, img.reshape(-1), 13, 9, c)
    px, w, h, ch = pngio.read_image(path)
    assert (w, h, ch) == (13, 9, c) and np.array_equal(px, img.reshape(-1))
    jax_path = str(tmp_path / "jax.png")
    jax_png._write_png_numpy(jax_path, img)
    assert _read(path) == _read(jax_path)
    pil = pytest.importorskip("PIL.Image")
    assert np.array_equal(np.asarray(pil.open(io.BytesIO(_read(path))))
                          .reshape(-1), img.reshape(-1))


def test_numpy_png_reader_refuses_what_it_does_not_read(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(pngio, "_HAVE_PIL", False)
    bad = tmp_path / "x.png"
    bad.write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="not a PNG"):
        pngio.read_image(str(bad))
    data = bytearray(_filtered_png(np.zeros((2, 2, 3), np.uint8), [0, 0]))
    data[24] = 16  # bit depth 16
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="8-bit"):
        pngio.read_image(str(bad))
