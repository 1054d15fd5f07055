"""Voting strategies (paper Algorithms 2 & 3).

UniVote: one cluster-level score |O+|/|O| compared to (lb, ub).
SimVote: per-tuple similarity-weighted score; the (N_unsampled x M_sampled)
similarity matrix is streamed through the CUDA simvote kernel on the card
(never materialized in device memory) and through the plain PyTorch
version on the CPU.

Similarity: Gaussian kernel sim(ei,ej) = exp(-||ei-ej||^2 / (2 tau^2)) with
a self-tuning bandwidth (median sampled-pair distance) unless given.  The
paper leaves sim() unspecified; a monotone-decreasing function of L2
distance matches its Fig. 2 analysis.

Batch entry points (``uni_vote_batch`` / ``sim_vote_batch``) vote ALL
clusters of a re-clustering round at once: one segmented device dispatch for
SimVote, one vectorized reduction for UniVote, with decisions identical to
the per-cluster calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.simvote.ops import (simvote_scores,
                                             simvote_scores_segmented)
from repro_torch.utils.device import resolve_device


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()


@dataclasses.dataclass
class VoteResult:
    decided_true: np.ndarray  # indices (into the cluster) voted True
    decided_false: np.ndarray
    undetermined: np.ndarray
    scores: np.ndarray  # per unsampled tuple (SimVote) or scalar (UniVote)


def _partition_by_score(scores: np.ndarray, lb: float, ub: float
                        ) -> VoteResult:
    idx = np.arange(len(scores))
    return VoteResult(idx[scores >= ub], idx[scores <= lb],
                      idx[(scores > lb) & (scores < ub)], scores)


def uni_vote(sample_labels: np.ndarray, n_unsampled: int, lb: float,
             ub: float) -> VoteResult:
    """Algorithm 2: every unsampled tuple gets the same cluster-level vote.

    An empty sample carries no evidence: everything is undetermined (a 0.0
    default score would silently vote False whenever lb >= 0).
    """
    idx = np.arange(n_unsampled)
    empty = np.array([], dtype=np.int64)
    if len(sample_labels) == 0:
        return VoteResult(empty, empty, idx, np.full(n_unsampled, np.nan))
    score = float(np.mean(sample_labels))
    if score >= ub:
        return VoteResult(idx, empty, empty, np.full(n_unsampled, score))
    if score <= lb:
        return VoteResult(empty, idx, empty, np.full(n_unsampled, score))
    return VoteResult(empty, empty, idx, np.full(n_unsampled, score))


def uni_vote_batch(sample_labels: Sequence[np.ndarray],
                   n_unsampled: Sequence[int], lb: float, ub: float
                   ) -> list[VoteResult]:
    """Algorithm 2 over every cluster of a round in one call.

    ``sample_labels[c]`` votes for ``n_unsampled[c]`` tuples.  Each cluster's
    score is computed by the exact ``uni_vote`` expression — UniVote has no
    device work to batch (one scalar mean per cluster), and reproducing
    ``np.mean``'s input-dtype arithmetic is what keeps round-executor
    decisions bit-identical to the sequential driver even when a score lands
    exactly on a threshold (float32 1/10 != float64 1/10).
    """
    return [uni_vote(np.asarray(s), int(n_c), lb, ub)
            for s, n_c in zip(sample_labels, n_unsampled)]


def vote_clusters(kind: str, sample_labels: Sequence[np.ndarray],
                  n_unsampled: Sequence[int], lb: float, ub: float,
                  emb_unsampled: Optional[Sequence[np.ndarray]] = None,
                  emb_sampled: Optional[Sequence[np.ndarray]] = None,
                  bandwidth: Optional[float] = None, *,
                  device="cuda") -> list[VoteResult]:
    """One segmented voting dispatch for a round, either strategy.

    The CSV round executor and the semantic join share this entry point:
    ``kind="uni"`` needs only per-cluster sample labels and unsampled counts;
    ``kind="sim"`` additionally takes the per-cluster embedding lists (for a
    join these are lazily built pair embeddings).  Decisions are identical to
    the per-cluster ``uni_vote`` / ``sim_vote`` calls.
    """
    labels = [np.asarray(s, np.float32) for s in sample_labels]
    if kind == "sim":
        assert emb_unsampled is not None and emb_sampled is not None
        return sim_vote_batch(emb_unsampled, emb_sampled, labels, lb, ub,
                              bandwidth, device=device)
    if kind != "uni":
        raise ValueError(f"unknown vote kind {kind!r}; expected 'uni' or 'sim'")
    return uni_vote_batch(labels, [int(c) for c in n_unsampled], lb, ub)


def default_bandwidth(emb_sampled: np.ndarray) -> float:
    """Self-tuning tau: median pairwise distance over (a subset of) samples."""
    m = emb_sampled.shape[0]
    if m < 2:
        return 1.0
    sub = emb_sampled[: min(m, 256)]
    d2 = np.sum((sub[:, None, :] - sub[None, :, :]) ** 2, axis=-1)
    med = float(np.median(np.sqrt(d2[np.triu_indices(len(sub), 1)])))
    return max(med, 1e-6)


def sim_vote(emb_unsampled: np.ndarray, emb_sampled: np.ndarray,
             sample_labels: np.ndarray, lb: float, ub: float,
             bandwidth: Optional[float] = None, *,
             device="cuda") -> VoteResult:
    """Algorithm 3: per-tuple similarity-weighted voting.

    As with ``uni_vote``, an empty sample carries no evidence — everything
    is undetermined (a zero denominator would otherwise score 0.0 and
    silently vote False whenever lb >= 0).
    """
    dev = resolve_device(device)
    n = emb_unsampled.shape[0]
    idx = np.arange(n)
    empty = np.array([], dtype=np.int64)
    if n == 0:
        z = np.zeros(0)
        return VoteResult(empty, empty, empty, z)
    if len(sample_labels) == 0:
        return VoteResult(empty, empty, idx, np.full(n, np.nan))
    tau = bandwidth or default_bandwidth(emb_sampled)
    scores = simvote_scores(_f32(emb_unsampled, dev), _f32(emb_sampled, dev),
                            _f32(sample_labels, dev), tau).cpu().numpy()
    return _partition_by_score(scores, lb, ub)


def sim_vote_batch(emb_unsampled: Sequence[np.ndarray],
                   emb_sampled: Sequence[np.ndarray],
                   sample_labels: Sequence[np.ndarray], lb: float, ub: float,
                   bandwidth: Optional[float] = None, *,
                   device="cuda") -> list[VoteResult]:
    """Algorithm 3 for every cluster of a round in ONE device dispatch.

    Per-cluster (x_c, s_c, y_c) ragged inputs are packed into a padded
    (C, max_m, D) sample tensor plus a concatenated unsampled matrix and
    scored by the segmented simvote kernel; bandwidths stay per-cluster
    (``default_bandwidth`` of each cluster's own sample, matching the
    sequential path).  ``emb_unsampled`` may hold tensors already on the
    device (the join gathers its pair rows there); they are concatenated
    there, never copied through the host.
    """
    dev = resolve_device(device)
    c = len(emb_unsampled)
    counts = np.array([len(x) for x in emb_unsampled], np.int64)
    out: list[Optional[VoteResult]] = [None] * c
    empty = np.array([], dtype=np.int64)
    # clusters with no unsampled rows have nothing to vote on; clusters with
    # an empty sample have no evidence (undetermined, matching sim_vote)
    live = [ci for ci in range(c)
            if counts[ci] > 0 and len(sample_labels[ci]) > 0]
    for ci in range(c):
        if counts[ci] == 0:
            out[ci] = VoteResult(empty, empty, empty, np.zeros(0))
        elif len(sample_labels[ci]) == 0:
            out[ci] = VoteResult(empty, empty, np.arange(counts[ci]),
                                 np.full(int(counts[ci]), np.nan))
    if not live:
        return out  # type: ignore[return-value]

    d = emb_unsampled[live[0]].shape[1]
    max_m = max(len(emb_sampled[ci]) for ci in live)
    s_pad = np.zeros((len(live), max_m, d), np.float32)
    y_pad = -np.ones((len(live), max_m), np.float32)
    taus = np.empty(len(live), np.float64)
    for r, ci in enumerate(live):
        m_c = len(emb_sampled[ci])
        s_pad[r, :m_c] = emb_sampled[ci]
        y_pad[r, :m_c] = sample_labels[ci]
        taus[r] = bandwidth or default_bandwidth(np.asarray(emb_sampled[ci]))
    if isinstance(emb_unsampled[live[0]], torch.Tensor):
        x_all = torch.cat([emb_unsampled[ci].to(dev, torch.float32)
                           for ci in live])
    else:
        x_all = _f32(np.concatenate([np.asarray(emb_unsampled[ci], np.float32)
                                     for ci in live]), dev)
    scores_all = simvote_scores_segmented(
        x_all, counts[live], _f32(s_pad, dev), _f32(y_pad, dev),
        taus).cpu().numpy()
    stop = np.cumsum(counts[live])
    for r, ci in enumerate(live):
        seg = scores_all[stop[r] - counts[ci]:stop[r]]
        out[ci] = _partition_by_score(seg, lb, ub)
    return out  # type: ignore[return-value]
