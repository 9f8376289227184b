"""Entry ``batch_decode``: ``BatchDecoder.__call__`` over the configuration's
images as one list of streams a call (one data-loader step).

Set-up makes the images on the first device from the seed
(``reference.corpus``), ``copies_per_call`` distinct draws of the
configuration's list, and writes each as a SQOA or ``.qoi`` stream (the traffic's ``format``) with
the reference encoder; the streams go to the host as ``bytes``, as a loader
reads files. A traffic mix with ``content_seed`` makes the images from that
seed instead, and the run's seed shuffles their order: every run then does
the same work (a ``.qoi`` decode's passes depend on the content, so other
seeds would change the work, not only the sample). One ``BatchDecoder`` is
made, on the first device or, when the configuration asks for a mesh, over
every device of the run, and every call decodes the same list.

The check: every kept call's results, in order, against the images the
streams were made from (the codec is lossless, so they are the reference's
decode; the benchmark's tests hold the reference decoder to that): each
result's pixels byte for byte and its desc field by field.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from benchmark.reference import codec, corpus

WARM_CALLS = 3  # calls of set-up, the first of which builds every kernel


class Entry:
    def __init__(self, config, traffic, seed, devices):
        from seqoia_tpu_torch.parallel import batch, mesh

        self.batch = batch
        qoi = traffic["format"] == "qoi"
        dev = devices[0]
        images = corpus.make_images(
            config["images"], traffic.get("content_seed", seed), dev,
            config.get("copies_per_call", 1))
        if "content_seed" in traffic:
            order = np.random.default_rng(seed).permutation(len(images))
            images = [images[i] for i in order]
        self.streams, self.expected, self.descs = [], [], []
        pieces = []
        for _, img in images:
            h, w, c = img.shape
            pieces.append(codec.encode(img, w, h, c, qoi=qoi))
            self.expected.append(img.reshape(-1).cpu().numpy())
            self.descs.append((w, h, c, 0, int(qoi)))
        flat = torch.cat(pieces).cpu().numpy()
        at = 0
        for p in pieces:
            self.streams.append(flat[at: at + p.numel()].tobytes())
            at += p.numel()
        del images, pieces, flat
        self.units = {
            "decoded_px": sum(d[0] * d[1] for d in self.descs),
            "stream_bytes": sum(len(s) for s in self.streams),
            "pixel_bytes": sum(e.size for e in self.expected),
        }
        if config.get("mesh"):
            self.dec = batch.BatchDecoder(mesh=mesh.default_mesh(devices))
        else:
            self.dec = batch.BatchDecoder(device=dev)
        self._compat: list = []

    def warm(self):
        for _ in range(WARM_CALLS):
            self.call()

    def call(self):
        return self.dec(self.streams)

    def control_call(self):
        """The reference in the program's place, one bit short of exact: its
        decode (the source images) with each sample's lowest bit dropped."""
        desc = self.batch.spec.SqoaDesc
        return [self.batch.DecodeResult(e & 0xFE, desc(*d))
                for e, d in zip(self.expected, self.descs)]

    def outcome(self, out):
        """(images attempted, images that came back as an error)."""
        return len(self.streams), sum(
            1 for r in out if r is None or r.error is not None
            or r.pixels is None)

    def counters(self):
        out = {"timings": dict(self.dec.last_timings),
               "stats": dict(self.dec.last_stats),
               "compat": self._compat}
        self._compat = []
        return out

    @contextlib.contextmanager
    def trace_patches(self):
        """For a traced run: ``decode_compat``'s counts (``stats=``, which
        ``BatchDecoder`` does not pass) gathered per call."""
        from seqoia_tpu_torch.codec import decode_compat

        fn = decode_compat.decode_stream_compat_batched

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            stats = kwargs.setdefault("stats", {})
            try:
                return fn(*args, **kwargs)
            finally:
                self._compat.append(stats)

        decode_compat.decode_stream_compat_batched = counted
        try:
            yield
        finally:
            decode_compat.decode_stream_compat_batched = fn

    def span_targets(self):
        from seqoia_tpu_torch.codec import decode_compat, decode_v2

        b = self.batch
        return [
            (b.BatchDecoder, "_run", "parallel.stage_class"),
            (b.BatchDecoder, "_finish", "parallel.unpack_class"),
            (b.BatchDecoder, "_host_pool", "parallel.host_pool"),
            (decode_v2, "decode_stream_batched", "codec.decode_stream_batched"),
            (decode_v2, "decode_stream_packed", "codec.decode_stream_packed"),
            (decode_compat, "decode_stream_compat_batched",
             "codec.decode_stream_compat_batched"),
        ]

    def close(self):
        self.dec = None

    def check(self, kept):
        """[(name, value, limit)] over the kept calls."""
        wrong_bytes = wrong_descs = missing = 0
        for results in kept:
            if len(results) != len(self.expected):
                missing += abs(len(self.expected) - len(results))
            for r, want, desc in zip(results, self.expected, self.descs):
                if r is None or r.pixels is None:
                    missing += 1
                    continue
                got = np.asarray(r.pixels, np.uint8).reshape(-1)
                if got.size != want.size:
                    wrong_bytes += max(got.size, want.size)
                else:
                    wrong_bytes += int(np.count_nonzero(got != want))
                if r.desc is None or (
                        r.desc.width, r.desc.height, r.desc.channels,
                        r.desc.colorspace, r.desc.qoi_compat) != desc:
                    wrong_descs += 1
        return [("wrong_pixel_bytes", wrong_bytes, 0),
                ("wrong_descs", wrong_descs, 0),
                ("missing_images", missing, 0)]
