"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source compiles to its own object (one ``nvcc`` per
source, all started together), and one link step joins them into a shared
library with a plain C interface.  The library lands in ``build/`` at the
repository root under a name that hashes the sources and flags, so an
edited kernel rebuilds and an unchanged one loads at once.  Nothing is
built when a module is imported: the first wrapper that launches a kernel
calls ``library()``.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C entry point -> argument types; every entry point returns cudaError_t
SIGNATURES = {
    "kmeans_assign": [P, P, P, P, P, I, I, I, I, P],
    "simvote_segmented": [P, P, P, P, P, P, P, P, I, I, I, P],
    "flash_attention_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, I, P],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> Path:
    """Compile every source in parallel, then link; returns the library."""
    nvcc = _nvcc()
    units = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in units:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib = out_dir / "librepro_torch_kernels.so"
    tmp = out_dir / (lib.name + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set is new."""
    out_dir = BUILD_DIR / f"kernels-{_digest()}"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "librepro_torch_kernels.so"
    with open(out_dir / "lock", "w") as lock:
        # one builder at a time when several processes start together
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The compiler's output from the build of the current sources."""
    path = BUILD_DIR / f"kernels-{_digest()}" / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {text} ({err})")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel takes CUDA tensors on one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream
