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
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
LLP = ctypes.POINTER(LL)
# C entry point -> argument types; every entry point returns cudaError_t
SIGNATURES = {
    "kmeans_assign": [P, P, P, P, I, I, I, I, I, P],
    "simvote_segmented": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    "flash_attention_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, I, LLP, P],
    "decode_attention_fwd": [P, P, P, P, P, I, I, I, I, I, LL, LL, LL, I, P],
    "selective_scan_fwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, LL, LL, I,
                           P],
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


_LOAD_LOCK = threading.Lock()
# guards every wrapper's ``launches`` count: the service launches kernels
# from several host threads, and ``+=`` on an attribute is not atomic
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (call right after a launch)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set is new.
    Thread-safe: the first of several threads to launch builds and loads
    it, the others wait."""
    with _LOAD_LOCK:
        return _library()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
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


def refuse_grad(name: str, *tensors: torch.Tensor,
                instead: str = 'differentiate through attn_impl="flash-ref" '
                '(or "auto"/"plain"), or call it under torch.no_grad()'
                ) -> None:
    """Raise where autograd would differentiate through a kernel that has
    no backward (K4, K5 and K6; the reference's Pallas kernels have no JVP
    rule): grad mode is on and an input requires grad.  The output of a
    ctypes launch carries no ``grad_fn``, so without this check the
    gradients upstream of the kernel would silently be zero.  ``instead``
    says what the caller should do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; {instead}")


def refuse_dtensor(name: str, *tensors: torch.Tensor) -> None:
    """Raise on a DTensor input: a kernel computes one whole tensor, and
    a partitioned program must not reach it through ``to_local()``, which
    would run it on one rank's shard as if it were the whole (the
    reference's Pallas calls are not partitioned either)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name} takes whole tensors, not DTensors; a partitioned "
            'program runs attention through attn_impl="auto" or "plain"')


def require_cuda(name: str, *tensors: torch.Tensor,
                 contiguous: bool = True) -> None:
    """A kernel takes CUDA tensors on one device, contiguous unless the
    kernel takes strides (``contiguous=False``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def vector_access(*tensors: torch.Tensor) -> bool:
    """Whether a kernel that moves 16 bytes at a time can take every
    tensor: each row (the last dimension, at stride 1) starts on a 16-byte
    boundary."""
    for t in tensors:
        step = 16 // t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(s % step for s, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1):
            return False
    return True


def vector_rows(*tensors: torch.Tensor) -> bool:
    """Whether every row of every tensor is a whole number of 16-byte
    loads that starts on 16 bytes (``vector_access``, and the last
    dimension a multiple of 16 bytes' elements)."""
    return vector_access(*tensors) and all(
        t.shape[-1] % (16 // t.element_size()) == 0 for t in tensors)


def require_vector_access(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless ``vector_access`` holds for every tensor."""
    for t in tensors:
        if not vector_access(t):
            raise ValueError(
                f"{name}: expected 16-byte aligned rows with the last "
                f"dimension at stride 1, got strides {t.stride()} at "
                f"offset {t.data_ptr() % 16} bytes from 16")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take it.

    The current stream is per thread.  A thread that sets none (the
    service's query threads and its dispatch lane) is on the device's
    default stream, where its tensors were made too, so each kernel runs
    after the work that produced its inputs."""
    return torch.cuda.current_stream(device).cuda_stream
