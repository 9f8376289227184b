"""The port's kernels, each beside its plain PyTorch version:
K1 ``frontend``, K2/K6 ``engine``, K3 ``encode_front``, K4 ``pack``,
K5 ``compact``, K7 ``slots``, K8 ``scan`` (with the scans of the compat
paths in ``scan_ops``), K9 ``sequential``, K10 ``ref`` and K11
``fixpoint``."""
