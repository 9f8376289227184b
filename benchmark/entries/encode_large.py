"""Entry ``encode_large``: ``seqoia_tpu_torch.encode_large`` of one image a
call, the configuration's images in turn (an archive writer).

Set-up makes the images on the first device from the seed
(``reference.corpus``) and hands the program host copies, as a writer holds
them; the device copies are freed before the window. The check: after the
window, the reference encoder (``reference.codec``, on the first device)
writes each kept call's image again, and the program's file bytes are
compared with it byte for byte.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import codec, corpus

WARM_CALLS = 3  # at least; every image once, the first call building kernels


class Entry:
    def __init__(self, config, traffic, seed, devices):
        import seqoia_tpu_torch as sq
        from seqoia_tpu_torch import spec

        self.sq = sq
        self.dev = devices[0]
        self.qoi = traffic["format"] == "qoi"
        images = corpus.make_images(config["images"], seed, self.dev,
                                    config.get("copies_per_call", 1))
        self.images, self.descs = [], []
        for _, img in images:
            h, w, c = img.shape
            self.images.append(img.reshape(-1).cpu().numpy())
            self.descs.append(spec.SqoaDesc(w, h, c, 0, int(self.qoi)))
        del images
        self.next = 0
        self.units = {}

    def warm(self):
        for _ in range(max(WARM_CALLS, len(self.images))):
            self.call()

    def _take(self):
        """The index of this call's image, the images in turn."""
        i = self.next
        self.next = (i + 1) % len(self.images)
        return i

    def _count(self, i, out):
        d = self.descs[i]
        self.units = {"encoded_px": d.n_pixels,
                      "pixel_bytes": d.n_pixels * d.channels,
                      "stream_bytes": len(out) if out is not None else 0}

    def call(self):
        i = self._take()
        out = self.sq.encode_large(self.images[i], self.descs[i],
                                   device=self.dev)
        self._count(i, out)
        return i, out

    def control_call(self):
        """The reference in the program's place, one bit short of exact: its
        encode of the image with each sample's lowest bit dropped."""
        i = self._take()
        d = self.descs[i]
        px = torch.from_numpy(self.images[i] & 0xFE).to(self.dev)
        out = codec.encode(px, d.width, d.height, d.channels,
                           qoi=self.qoi).cpu().numpy().tobytes()
        self._count(i, out)
        return i, out

    def outcome(self, out):
        return 1, int(out[1] is None)

    def counters(self):
        return {}

    def trace_patches(self):
        return contextlib.nullcontext()

    def span_targets(self):
        from seqoia_tpu_torch.codec import encode_v2
        from seqoia_tpu_torch.ops import pack
        from seqoia_tpu_torch.parallel import tiled
        from seqoia_tpu_torch.utils import transfer

        return [
            (pack, "normalize_pixels_device",
             "parallel.normalize_pixels_device"),
            (encode_v2, "encode_stream_flat", "codec.encode_stream_flat"),
            (transfer, "fetch_flat", "parallel.fetch_flat"),
            (tiled, "_file_bytes", "parallel.file_bytes"),
        ]

    def close(self):
        pass

    def check(self, kept):
        """[(name, value, limit)] over the kept calls."""
        wrong = missing = 0
        want = {}
        for i, out in kept:
            if out is None:
                missing += 1
                continue
            if i not in want:
                d = self.descs[i]
                want[i] = codec.encode(
                    torch.from_numpy(self.images[i]).to(self.dev), d.width,
                    d.height, d.channels, qoi=self.qoi).cpu().numpy()
            ref = want[i]
            got = np.frombuffer(out, np.uint8)
            n = min(got.size, ref.size)
            wrong += int(np.count_nonzero(got[:n] != ref[:n]))
            wrong += abs(got.size - ref.size)
        return [("wrong_stream_bytes", wrong, 0),
                ("missing_streams", missing, 0)]
