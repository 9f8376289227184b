"""The table of peaks the roofline shares are taken against.

Frozen from ``chip_smoke.py`` (``HBM_BYTES_PER_S``) at commit
3cb6c7040ff08e3b59fac3692353cf41f41151ef: NVIDIA's data sheet for the
H100 SXM, 80 GB of HBM3 at 3.35 TB/s, at the card's full 700 W; a card set
below that limit runs slower under load, so the power limit is printed
beside every run. A codec does no floating-point work worth a peak: its
kernels are bound by memory, so the byte bound alone is used.
"""

HBM_BYTES_PER_S = 3.35e12


def byte_bound_s(nbytes: float) -> float:
    """The least time the card can take to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S
