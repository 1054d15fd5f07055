"""Plain PyTorch version of the k-means assignment step."""
from __future__ import annotations

import torch


def assign_clusters_ref(x: torch.Tensor, cents: torch.Tensor):
    """x (N,D), cents (K,D) -> (assign (N,) int32, dmin (N,) f32).

    Squared-L2 distances via the expansion ||x||^2 - 2 x.c + ||c||^2.
    """
    xf = x.float()
    cf = cents.float()
    xsq = torch.sum(xf * xf, dim=-1, keepdim=True)  # (N,1)
    csq = torch.sum(cf * cf, dim=-1)  # (K,)
    d = xsq - 2.0 * (xf @ cf.T) + csq[None, :]  # (N,K)
    d = torch.clamp(d, min=0.0)
    return torch.argmin(d, dim=-1).to(torch.int32), torch.min(d, dim=-1).values
