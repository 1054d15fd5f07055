"""Dispatcher: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor.  A CUDA tensor never reaches the plain version."""
from __future__ import annotations

from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
from repro_torch.kernels.kmeans.ref import assign_clusters_ref


def assign_clusters(x, cents):
    """(assign (N,) int32, dmin (N,) f32) — dispatched on x's device."""
    if x.device.type == "cpu":
        return assign_clusters_ref(x, cents)
    return assign_clusters_cuda(x, cents)
