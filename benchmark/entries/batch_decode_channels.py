"""Entry ``batch_decode_channels``: ``BatchDecoder.__call__(streams,
channels)`` over the configuration's images as one list of streams a call,
at the traffic's ``channels`` (a loader that asks for a fixed number of
channels, whatever the files hold).

Everything but the call and the expected output is ``batch_decode``'s
(``Entry`` there): the images and streams made from the seed, the decoder,
the outcome, the counters and the check. The expected output of each image
is its file as the reference decodes it at ``channels`` (``expected_at``,
held to ``reference.codec.decode`` by the benchmark's tests): a gray source
at 3 or 4 channels is its gray replicated to R, G and B. Each desc is still
the file's. The traced spans add K6 (``engine.place_fill``), which fills
the pixels K2 cannot emit; the emit that follows it is the program's own
span ``codec.emit_pixels``, under the span of ``decode_stream_batched``.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import manifest

_base = manifest.load_module("entries", "batch_decode")


def expected_at(src: np.ndarray, c: int, channels: int) -> np.ndarray:
    """The reference decode at ``channels`` (0: the file's own) of the file
    made from the flat interleaved pixels ``src`` of ``c`` channels, as
    ``reference.codec.decode`` writes each pixel: a colour source gives R, G, B or, at 1 or 2
    channels, its G; a gray source its gray, three times at 3 or 4; an even
    count ends in the alpha, 255 where the source has none."""
    if not channels or channels == c:
        return src
    px = src.reshape(-1, c)
    if c >= 3 and channels >= 3:
        cols = [px[:, 0], px[:, 1], px[:, 2]]
    else:
        cols = [px[:, 0 if c < 3 else 1]] * (3 if channels >= 3 else 1)
    if channels % 2 == 0:
        cols.append(px[:, c - 1] if c % 2 == 0
                    else np.full(len(px), 255, np.uint8))
    return np.stack(cols, axis=1).reshape(-1)


class Entry(_base.Entry):
    def __init__(self, config, traffic, seed, devices):
        super().__init__(config, traffic, seed, devices)
        self.channels = traffic["channels"]
        self.expected = [expected_at(e, d[2], self.channels)
                         for e, d in zip(self.expected, self.descs)]
        self.units["pixel_bytes"] = sum(e.size for e in self.expected)

    def call(self):
        return self.dec(self.streams, self.channels)

    def span_targets(self):
        from seqoia_tpu_torch.ops import engine

        return super().span_targets() + [
            (engine, "place_fill", "kernels.place_fill")]
