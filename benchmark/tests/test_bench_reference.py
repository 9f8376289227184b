"""The benchmark's plain codec (``reference/codec.py``) against the port's
native C codec, on the configurations' images at a small size."""

import numpy as np
import pytest
import torch

from benchmark.reference import codec, corpus
from benchmark.tests.small import EVERY_GENERATOR
from seqoia_tpu_torch import native


def _sample(seed):
    return corpus.make_images(EVERY_GENERATOR, seed, "cpu")


@pytest.mark.parametrize("qoi", [False, True])
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_encoder_matches_native_and_round_trips(qoi, seed):
    n = 0
    for cat, img in _sample(seed):
        h, w, c = img.shape
        if qoi and c < 3:
            continue
        flat = img.reshape(-1).numpy()
        mine = bytes(codec.encode(img, w, h, c, qoi=qoi).numpy())
        assert mine == native.encode(flat, w, h, c, 0, int(qoi)), cat
        pix, desc = codec.decode(mine)
        assert bytes(pix) == flat.tobytes(), cat
        assert desc == (w, h, c, 0, int(qoi))
        npix, _ = native.decode(mine)
        assert npix.tobytes() == flat.tobytes(), cat
        n += 1
    assert n >= 7


def test_edge_images():
    """Runs across the BIGRUN and 61-byte flush edges, a trailing run, an
    image of one repeated initial pixel, the all-zero pixel's INDEX hit,
    and gray images with alpha."""
    rng = np.random.default_rng(3)
    cases = []
    for L in (1, 60, 61, 62, 122, 123, 511, 512, 513, 1025, 1500):
        px = np.zeros((L + 2, 3), np.uint8)
        px[0] = 7
        px[-1] = 9
        cases.append((px, 3))
        cases.append((px[:-1], 3))  # ends in the run
    cases.append((np.tile(np.array([[0, 0, 0, 255]], np.uint8), (700, 1)),
                  4))
    cases.append((np.zeros((300, 4), np.uint8), 4))
    g = rng.integers(0, 256, (500, 2)).astype(np.uint8)
    g[::3, 1] = 255
    cases.append((g, 2))
    cases.append((np.cumsum(rng.integers(-9, 10, (500, 1)), 0).astype(
        np.uint8), 1))
    for px, c in cases:
        w, h = px.shape[0], 1
        for qoi in ([False, True] if c >= 3 else [False]):
            mine = bytes(codec.encode(torch.from_numpy(px.copy()), w, h, c,
                                      qoi=qoi).numpy())
            assert mine == native.encode(px.ravel(), w, h, c, 0, int(qoi))
            assert bytes(codec.decode(mine)[0]) == px.tobytes()


@pytest.mark.parametrize("seed", [0, 9])
def test_random_images(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        c = int(rng.integers(1, 5))
        w, h = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        pal = rng.integers(0, 256, (4, c))
        px = pal[rng.integers(0, 4, w * h)]
        px = np.clip(px + rng.integers(-2, 3, px.shape)
                     * (rng.random(px.shape) < 0.3), 0, 255).astype(np.uint8)
        for qoi in ([False, True] if c >= 3 else [False]):
            mine = bytes(codec.encode(torch.from_numpy(px), w, h, c,
                                      qoi=qoi).numpy())
            assert mine == native.encode(px.ravel(), w, h, c, 0, int(qoi))
            assert bytes(codec.decode(mine)[0]) == px.tobytes()


def test_same_seed_same_images():
    a = _sample(2**33 + 1)
    b = _sample(2**33 + 1)
    c = _sample(2**33 + 2)
    assert [x[0] for x in a] == [x[0] for x in b]
    assert all(torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert not all(torch.equal(x[1], y[1]) for x, y in zip(a, c))
