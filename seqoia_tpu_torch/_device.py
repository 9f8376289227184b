"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """The torch device for ``device``; a CUDA device must exist. The port
    runs on the card unless the caller asks for the CPU: it never falls
    back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
