"""The port's kernels, each beside its plain PyTorch version:
K1 ``frontend``, K2/K6 ``engine``, K3 ``encode_front``."""
