"""The benchmark of ``seqoia_tpu_torch`` on NVIDIA cards (``run.py``)."""
