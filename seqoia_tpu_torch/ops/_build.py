"""Build and load the port's native libraries.

The CUDA kernels live in ``seqoia_tpu_torch/csrc/*.cu`` with a plain C
interface: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` turns each
source into its own shared library, loaded with ctypes (no PyTorch headers,
so a build takes seconds). Libraries go into ``seqoia_tpu_torch/_build/``
(git-ignored), named by a hash of their sources, so a stale build is never
loaded and concurrent builders never see a half-written file.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` returns the library for one source, building it first
if needed. Every C entry point takes the stream last and returns
``cudaGetLastError()`` after its launches; ``launch(lib, fn, dev, *args)``
calls one on ``dev``'s current stream, with ``dev`` the current device, and
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# csrc/<name>.cu -> its C entry points and their arguments: p = pointer
# (or the stream), i = int, q = long long
_SIGNATURES = {
    "frontend": {"k1_decode_front": "ppiqiiiipppppp"},
    "engine": {"k2_place": "ipppppqiipiiiiippppp"},
    "encode_front": {"k3_encode_front": "ppppiqipppppppp"},
    "pack": {"k4_pack_words": "ppqip"},
    "compact": {"k5_compact": "ppppiipppppp"},
    "slots": {"k7_slots": "ppppiiiippp"},
    "scan": {"k8_scan": "ippiipppp"},
    "sequential": {"k9_sequential_decode": "pppiiipp",
                   "k9_smem_chase": "ippp"},
    "ref": {"k10_ref_decode": "piiqiipppp", "k10_ldg_chase": "piiiippp",
            "k10_shared_bytes": ""},
    "fixpoint": {"k11_values": "pqpqpqpiipppp", "k11_stable": "ppiipp"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong}
KERNELS = tuple(_SIGNATURES)

_lock = threading.Lock()
_libs: dict = {}


def _sources(name: str) -> list:
    hdrs = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    )
    return [os.path.join(CSRC, name + ".cu")] + hdrs


def _target(name: str) -> str:
    h = hashlib.sha1()
    for p in _sources(name):
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def compile_shared(cmd_prefix: list, out: str) -> subprocess.Popen:
    """Start ``cmd_prefix + ['-o', tmp]`` writing into a temporary file in
    BUILD_DIR; ``finish_shared`` renames it to ``out`` atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen(
        cmd_prefix + ["-o", tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    proc.tmp_path, proc.out_path = tmp, out
    return proc


def finish_shared(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(proc.tmp_path)
        raise RuntimeError(f"build of {proc.out_path} failed:\n{log}")
    os.replace(proc.tmp_path, proc.out_path)
    return log


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def nvcc_command(source: str) -> list:
    """The nvcc command (less its output) that builds ``source``, a .cu file
    with the headers of its own directory, into a shared library."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", os.path.dirname(source), source,
    ]


def _start(name: str) -> subprocess.Popen:
    return compile_shared(nvcc_command(os.path.join(CSRC, name + ".cu")),
                          _target(name))


def build_all() -> dict:
    """Build every kernel library not yet built, all nvcc runs in parallel.
    Returns {name: ptxas log} for the libraries built by this call."""
    procs = {n: _start(n) for n in KERNELS if not os.path.exists(_target(n))}
    return {n: finish_shared(p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not os.path.exists(path):
                finish_shared(_start(name))
            lib = ctypes.CDLL(path)
            for fn, sig in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = [_CTYPES[c] for c in sig]
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def launch(lib, fn: str, dev, *args) -> None:
    """Call the C entry point ``fn`` of ``lib`` (a library or the name of its
    source) with ``args`` and the current stream of ``dev``, a CUDA device
    with an index, and raise if it returns an error. The entry points act on
    the runtime's current device (K10 raises its shared-memory limit there,
    and a launch into a stream of another device is not defined to work),
    so the call runs with ``dev`` current: the guard is entered only when it
    is not, which keeps the one-card path at one query of the current
    device a launch."""
    import torch

    if isinstance(lib, str):
        lib = load(lib)
    idx = dev.index
    if idx == torch.cuda.current_device():
        rc = getattr(lib, fn)(*args, stream_ptr(dev))
    else:
        with torch.cuda.device(idx):
            rc = getattr(lib, fn)(*args, stream_ptr(dev))
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {fn} failed: cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> null)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
