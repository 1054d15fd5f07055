"""Dispatcher: the CUDA kernel (K6) for CUDA tensors, the plain version for
CPU tensors; no fallback from one to the other."""
from __future__ import annotations

from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
from repro_torch.kernels.selective_scan.ref import selective_scan_ref


def selective_scan(x, dt, B, C, z, A, D, h0=None, *, chunk=None):
    """``selective_scan_cuda``'s function.  ``chunk`` bounds the plain
    version's (Bt, chunk, di, ds) temporaries; the kernel has none."""
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, B, C, z, A, D, h0, chunk=chunk)
    return selective_scan_cuda(x, dt, B, C, z, A, D, h0)
