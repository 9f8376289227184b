"""Device meshes: the devices a batch or a large image is spread over.

Port of ``seqoia_tpu/parallel/mesh.py``. A JAX ``Mesh`` is driven by one
controller process that launches on every device of it, and the JAX package
never starts a process group. The port's mesh is the same thing in
PyTorch: a tuple of ``torch.device``s that one process launches on. Kernel
launches are asynchronous on each device, so the devices run at once, and
no ``torch.distributed`` process group is needed.

A mesh may name one device several times: each entry takes its own share
of the rows (``batch_sharding``) or its own shard of a large image, and the
entries that share a device run as one batch there. ``(cuda:0,) * 4`` runs
the four-way split on one card, and ``(cpu,) * k`` runs it on the kernels'
plain versions.
"""

from __future__ import annotations

import torch

from .._device import resolve


def default_mesh(devices=None) -> tuple:
    """The mesh of ``devices`` (default: every visible CUDA device), as a
    tuple of indexed ``torch.device``s. With no card and no ``devices`` it
    raises: a mesh never falls back to the CPU on its own."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device: pass devices=, e.g. (torch.device('cpu'),) "
                "* k, to run the plain PyTorch versions on a mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = []
    for d in devices:
        dev = resolve(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh.append(dev)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return tuple(mesh)


def batch_sharding(mesh, n_rows: int) -> list:
    """Contiguous row ranges of a class of ``n_rows`` rows, one per mesh
    entry in order, the first ``n_rows % len(mesh)`` one row longer; the
    empty ones are left out. Returns [(device, start, stop)]."""
    k = len(mesh)
    base, extra = divmod(int(n_rows), k)
    out, start = [], 0
    for i, dev in enumerate(mesh):
        stop = start + base + (i < extra)
        if stop > start:
            out.append((dev, start, stop))
        start = stop
    return out
