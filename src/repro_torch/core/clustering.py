"""K-means over tuple embeddings (paper phase 1, query-agnostic, offline).

Lloyd iterations as a host loop with the reference's max-shift stopping
test, re-seeding of empty clusters to the worst-fit point, and a final
assignment plus inertia.  The assignment step (N x K distances + argmin)
goes through ``repro_torch.kernels.kmeans.ops``: the CUDA kernel on the card,
the plain version on the CPU.

Seeding is a hook, ``init_centroids(seed, x, k) -> (k, D) array``: the
reference seeds k-means++ from ``jax.random``, which torch cannot
reproduce, so a caller that needs the reference's centroids injects them
here.  The default is ``plusplus_init`` on a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.kmeans.ops import assign_clusters
from repro_torch.utils.device import resolve_device

Seeder = Callable[[int, np.ndarray, int], np.ndarray]


def plusplus_init(seed: int, x: np.ndarray, k: int) -> np.ndarray:
    """k-means++ seeding on a ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    xt = torch.as_tensor(np.asarray(x))
    n = xt.shape[0]
    first = int(torch.randint(0, n, (1,), generator=g))
    cents = torch.zeros((k, xt.shape[1]), dtype=xt.dtype)
    cents[0] = xt[first]
    d2 = torch.sum((xt - cents[0]) ** 2, dim=-1)
    for i in range(1, k):
        probs = d2 / torch.clamp(torch.sum(d2), min=1e-30)
        idx = int(torch.multinomial(probs, 1, generator=g))
        cents[i] = xt[idx]
        d2 = torch.minimum(d2, torch.sum((xt - cents[i]) ** 2, dim=-1))
    return cents.numpy()


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kmeans(seed: int, x, k: int, max_iters: int = 50, tol: float = 1e-4, *,
           init_centroids: Optional[Seeder] = None, device="cuda"):
    """Lloyd's algorithm.  x (N,D) -> (centroids (k,D), assign (N,), inertia).

    ``seed`` is the integer the reference passes to ``jax.random.key``.
    Empty clusters are re-seeded to the point farthest from its centroid.
    Returns tensors on ``device``.
    """
    dev = resolve_device(device)
    x_np = _as_numpy(x)
    xt = torch.as_tensor(x_np, device=dev)
    d = xt.shape[1]
    seeder = init_centroids if init_centroids is not None else plusplus_init
    cents = torch.tensor(np.asarray(seeder(seed, x_np, k)), dtype=xt.dtype,
                         device=dev)
    if tuple(cents.shape) != (k, d):
        raise ValueError(f"seeder returned {tuple(cents.shape)}, expected "
                         f"{(k, d)}")
    it, moving = 0, True
    while it < max_iters and moving:
        assign, dmin = assign_clusters(xt, cents)
        # per-cluster sums as a product with the one-hot assignment, not a
        # scatter-add: CUDA's atomic adds land in a varying order, and the
        # product gives the same centroids on every run
        onehot = F.one_hot(assign.long(), k).to(xt.dtype)  # (N, k)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ xt
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp(counts[:, None], min=1.0), cents)
        # re-seed empties with the worst-fit point
        worst = torch.argmax(dmin)
        new = torch.where(counts[:, None] == 0, xt[worst][None, :], new)
        # max shift compared with tol in x's dtype, as the reference does
        moving = bool(torch.max(torch.sum((new - cents) ** 2, dim=-1)) > tol)
        cents = new.contiguous()
        it += 1
    assign, dmin = assign_clusters(xt, cents)
    inertia = torch.sum(dmin)
    return cents, assign, inertia


def kmeans_predict(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    assign, _ = assign_clusters(x, cents)
    return assign


def assign_to_nearest(embeddings, centroids, *, device="cuda") -> np.ndarray:
    """Host-side incremental assignment (paper §3.1 update handling).

    New or updated rows join the nearest *existing* centroid — no re-fit.
    """
    dev = resolve_device(device)
    emb = torch.as_tensor(np.asarray(embeddings, dtype=np.float32),
                          device=dev)
    cents = torch.as_tensor(np.asarray(centroids), device=dev).contiguous()
    return kmeans_predict(emb, cents).cpu().numpy()


def minibatch_kmeans_update(cents: torch.Tensor, counts: torch.Tensor,
                            batch: torch.Tensor):
    """Mini-batch K-means (Sculley'10) single step for incremental updates.

    counts (k,): running per-cluster sample counts.  Returns (cents, counts).
    """
    assign, _ = assign_clusters(batch, cents)
    a = assign.long()
    ones = torch.ones(batch.shape[0], dtype=cents.dtype, device=cents.device)
    counts = counts.index_add(0, a, ones)
    lr = 1.0 / torch.clamp(counts[a], min=1.0)  # per-sample rate
    k = cents.shape[0]
    sums = torch.zeros_like(cents).index_add(0, a, batch * lr[:, None])
    hits = torch.zeros((k,), dtype=cents.dtype, device=cents.device
                       ).index_add(0, a, lr)
    cents = cents * (1 - hits[:, None]) + sums + cents * 0.0
    return cents, counts


_STEP_ROWS = 1 << 16  # rows widened to f64 at a time in the step below


def distributed_kmeans_step(x_local: torch.Tensor, cents: torch.Tensor,
                            group=None) -> torch.Tensor:
    """One Lloyd step over rows spread across ranks: local sums + all-reduce.

    Each rank passes its own rows ``x_local`` and the same (replicated)
    centroids; the per-cluster sums and counts of K1's assignment are
    summed over ``group`` with ``torch.distributed.all_reduce`` (the
    reference's ``lax.psum`` under ``shard_map``).  Runs where the tensors
    are.  Returns the updated centroids, equal on every rank.  Raises when
    no process group is initialised: a local step would silently ignore
    the other ranks' rows.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "distributed_kmeans_step needs an initialised torch.distributed "
            "process group (torch.distributed.init_process_group)")
    k, d = cents.shape
    assign, _ = assign_clusters(x_local, cents)
    a = assign.long()
    # f64 sums, a bounded slab of rows at a time: f32 adds over ~10^4
    # rows a cluster drift by up to ~1e-5 of the mean
    sums = torch.zeros((k, d), dtype=torch.float64, device=x_local.device)
    for r in range(0, x_local.shape[0], _STEP_ROWS):
        sums.index_add_(0, a[r:r + _STEP_ROWS],
                        x_local[r:r + _STEP_ROWS].double())
    counts = torch.bincount(a, minlength=k).double()
    dist.all_reduce(sums, group=group)
    dist.all_reduce(counts, group=group)
    means = (sums / torch.clamp(counts[:, None], min=1.0)).to(cents.dtype)
    return torch.where(counts[:, None] > 0, means, cents)
