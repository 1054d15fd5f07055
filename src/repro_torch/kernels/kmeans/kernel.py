"""ctypes wrapper of the hand-written k-means assignment kernel (K1).

The CUDA source is ``repro_torch/csrc/kmeans_assign.cu``; it replaces the
Pallas kernel ``assign_clusters_pallas``
(src/repro/kernels/kmeans/kernel.py:37).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def assign_clusters_cuda(x: torch.Tensor, cents: torch.Tensor):
    """x (N,D), cents (K,D) on the card -> (assign (N,) int32, dmin (N,) f32)."""
    build.require_cuda("assign_clusters_cuda", x, cents)
    if x.dtype != cents.dtype or x.dtype not in DTYPE_CODES:
        raise TypeError(f"assign_clusters_cuda takes float32 or bfloat16, "
                        f"got {x.dtype} and {cents.dtype}")
    n, d = x.shape
    k, d2 = cents.shape
    if d != d2 or k == 0:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(cents.shape)}")
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    dmin = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, dmin
    csq = torch.sum(cents.float() ** 2, dim=-1)
    err = build.library().kmeans_assign(
        x.data_ptr(), cents.data_ptr(), csq.data_ptr(), assign.data_ptr(),
        dmin.data_ptr(), n, d, k, DTYPE_CODES[x.dtype],
        build.stream_ptr(x.device))
    build.check(err, "kmeans_assign")
    assign_clusters_cuda.launches += 1
    return assign, dmin


assign_clusters_cuda.launches = 0
