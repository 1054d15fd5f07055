"""CSV-backed semantic join: sem_join(L, R, predicate) without |L|x|R| calls.

Pair *embeddings and LLM calls* stay sublinear in |L| x |R|; decision state
(the output ``pair_mask`` and a ``decided`` tracker) is two dense bool
matrices — cheap to ~10^8 pairs, after which sparse bookkeeping is needed
(ROADMAP open item).  Both sides are clustered
offline (reusing each SemanticTable's precluster cache); every cluster pair
(A, B) becomes a *block* — a |A| x |B| grid of candidate pairs assumed to
share one predicate rate, the join analogue of a CSV cluster.  Each round:

1. **plan**: every block samples ``max(min_sample, ceil(xi * n_undecided))``
   still-undecided pairs (driver RNG, deterministic under the seed);
2. **oracle**: ALL blocks' sampled pair ids go out in ONE cross-block batch
   (``pair id = i * |R| + j``), the round-vectorized idiom of the filter
   executor;
3. **vote**: one segmented ``vote_clusters`` dispatch labels every block's
   remaining pairs — UniVote from the block's sample rate (default), or
   SimVote over concatenated ``[e_L(i); e_R(j)]`` pair embeddings (built
   per block; quadratic in block side, so prefer "uni" for large blocks;
   both sides are uploaded to ``device`` once and the unsampled pair rows
   are gathered there);
4. **refine**: undetermined blocks split their larger side by 2-means and
   re-enter the queue; blocks whose undecided remainder is small
   (<= min_sample)
   or whose refinement budget is exhausted fall back to direct oracle calls,
   so every pair is decided with bounded work.

K-means (the side clusterings and 2-means splits, K1 on the card) and the
SimVote blocks (K3, at the pair width 2 x D) run on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.clustering import Seeder, kmeans
from repro_torch.core.voting import vote_clusters
from repro_torch.obs.trace import get_tracer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import monotonic


@dataclasses.dataclass
class JoinConfig:
    n_clusters_left: int = 4
    n_clusters_right: int = 4
    xi: float = 0.005
    min_sample: int = 101
    lb: float = 0.15
    ub: Optional[float] = None  # default 1 - lb
    max_refine: int = 3
    vote: str = "uni"  # "uni" | "sim" (sim materializes per-block pair embs)
    sim_bandwidth: Optional[float] = None
    kmeans_iters: int = 50
    seed: int = 0

    @property
    def ub_(self) -> float:
        return self.ub if self.ub is not None else 1.0 - self.lb


def pair_ids(i: np.ndarray, j: np.ndarray, n_right: int) -> np.ndarray:
    """Flat pair id convention: id(i, j) = i * |R| + j (int64)."""
    return np.asarray(i, np.int64) * int(n_right) + np.asarray(j, np.int64)


@dataclasses.dataclass
class JoinBlock:
    """One cluster pair: the candidate grid left x right."""
    left: np.ndarray
    right: np.ndarray

    @property
    def n_pairs(self) -> int:
        return int(len(self.left)) * int(len(self.right))


@dataclasses.dataclass
class JoinRound:
    depth: int
    n_blocks: int
    n_sampled: int
    n_voted: int
    n_undetermined: int


@dataclasses.dataclass
class JoinResult:
    pair_mask: np.ndarray  # (|L|, |R|) bool — pairs satisfying the predicate
    n_llm_calls: int
    input_tokens: int
    output_tokens: int
    n_voted: int      # pairs decided by voting (no LLM call)
    n_fallback: int   # pairs decided by direct oracle fallback
    refine_rounds: int
    total_time_s: float
    round_log: list = dataclasses.field(default_factory=list)

    @property
    def pairs(self) -> np.ndarray:
        """(K, 2) int array of joined (left, right) index pairs."""
        return np.argwhere(self.pair_mask)


def _side_assign(emb: np.ndarray, k: int, seed: int,
                 precomputed: Optional[np.ndarray], init_centroids,
                 device) -> np.ndarray:
    if precomputed is not None:
        return np.asarray(precomputed)
    k = min(k, len(emb))
    _, assign, _ = kmeans(seed, emb, k, init_centroids=init_centroids,
                          device=device)
    return assign.cpu().numpy()


def _pair_embs(el, er, li: np.ndarray, rj: np.ndarray):
    """``[e_L(i); e_R(j)]`` rows: numpy for numpy sides, and for tensor
    sides a gather on their device."""
    if isinstance(el, torch.Tensor):
        return torch.cat([el[torch.as_tensor(li, device=el.device)],
                          er[torch.as_tensor(rj, device=er.device)]], dim=1)
    return np.concatenate([el[li], er[rj]], axis=1)


def _split_block(b: JoinBlock, el: np.ndarray, er: np.ndarray,
                 cfg: JoinConfig, depth: int, init_centroids,
                 device) -> list:
    """Refine: 2-means split of the block's larger side."""
    split_left = len(b.left) >= len(b.right)
    side = b.left if split_left else b.right
    emb = el if split_left else er
    _, a, _ = kmeans(cfg.seed + depth, emb[side], 2,
                     max_iters=cfg.kmeans_iters,
                     init_centroids=init_centroids, device=device)
    a = a.cpu().numpy()
    parts = [side[a == 0], side[a == 1]]
    parts = [p for p in parts if len(p)]
    if len(parts) == 1:  # degenerate embeddings: halve deterministically
        h = len(side) // 2
        parts = [side[:h], side[h:]]
    if split_left:
        return [JoinBlock(p, b.right) for p in parts]
    return [JoinBlock(b.left, p) for p in parts]


def sem_join(emb_left: np.ndarray, emb_right: np.ndarray, oracle,
             cfg: Optional[JoinConfig] = None,
             assign_left: Optional[np.ndarray] = None,
             assign_right: Optional[np.ndarray] = None, *,
             init_centroids: Optional[Seeder] = None,
             device="cuda") -> JoinResult:
    """Join two embedding tables under a pair-level semantic predicate.

    oracle: callable over flat pair ids (``pair_ids``) -> bool array, with
    ``.stats`` accounting — e.g. a SyntheticOracle over flattened pair
    labels, or a ModelOracle whose prompt renders both tuple texts.
    init_centroids: k-means seeder hook ``(seed, x, k) -> (k, D)``; it gets
    ``cfg.seed`` for the side clusterings and ``cfg.seed + depth`` for each
    2-means split (default: ``repro_torch.core.clustering.plusplus_init``).
    device: where k-means and SimVote run; ``"cuda"`` unless the caller
    asks for ``"cpu"``.
    """
    device = resolve_device(device)
    cfg = cfg or JoinConfig()
    tr = get_tracer()
    t0 = monotonic()
    rng = np.random.default_rng(cfg.seed)
    el = np.asarray(emb_left, np.float32)
    er = np.asarray(emb_right, np.float32)
    nl, nr = len(el), len(er)
    before = oracle.stats.clone()
    lb, ub = cfg.lb, cfg.ub_

    # both sides cluster under cfg.seed — identical to what the table API's
    # precluster cache produces, so reuse_clustering=False is bit-compatible
    al = _side_assign(el, cfg.n_clusters_left, cfg.seed, assign_left,
                      init_centroids, device)
    ar = _side_assign(er, cfg.n_clusters_right, cfg.seed, assign_right,
                      init_centroids, device)
    lclusters = [np.nonzero(al == c)[0] for c in range(int(al.max()) + 1)]
    rclusters = [np.nonzero(ar == c)[0] for c in range(int(ar.max()) + 1)]
    blocks = [JoinBlock(lc, rc) for lc in lclusters if len(lc)
              for rc in rclusters if len(rc)]

    if cfg.vote == "sim":
        # the unsampled pair rows are gathered from these on the device
        el_dev = torch.as_tensor(el, device=device)
        er_dev = torch.as_tensor(er, device=device)
    mask = np.zeros((nl, nr), dtype=bool)
    decided = np.zeros((nl, nr), dtype=bool)
    n_voted = n_fallback = 0
    round_log: list = []
    depth = 0
    while blocks:
        with tr.span("round", kind="round", depth=depth,
                     n_blocks=len(blocks), executor="join") as rsp:
            t_round = monotonic()
            # ---- plan: sample still-undecided pairs in every block ----
            with tr.span("plan", kind="plan"):
                plans = []
                for b in blocks:
                    undec = np.nonzero(
                        ~decided[np.ix_(b.left, b.right)].ravel())[0]
                    if len(undec) == 0:
                        continue
                    n_s = theory.choose_sample_size(len(undec), cfg.xi,
                                                    cfg.min_sample)
                    pick = rng.choice(len(undec), size=n_s, replace=False)
                    flat = undec[pick]
                    rest = np.setdiff1d(undec, flat, assume_unique=False)
                    li = b.left[flat // len(b.right)]
                    rj = b.right[flat % len(b.right)]
                    plans.append((b, li, rj, rest))
            if not plans:
                break

            # ---- one cross-block oracle batch for the whole round ----
            with tr.span("oracle", kind="oracle") as osp:
                batch = np.concatenate([pair_ids(li, rj, nr)
                                        for (_, li, rj, _) in plans])
                flat_labels = oracle(batch)
                osp.set(batch=int(len(batch)))
            offsets = np.cumsum([len(li) for (_, li, rj, _) in plans])[:-1]
            labels_by_block = np.split(flat_labels, offsets)
            for (b, li, rj, _), lab in zip(plans, labels_by_block):
                mask[li, rj] = lab
                decided[li, rj] = True

            # ---- one segmented voting dispatch over live blocks ----
            with tr.span("vote", kind="vote", n_blocks=len(plans)):
                live = [i for i, p in enumerate(plans) if len(p[3])]
                rest_lr = {}
                for i in live:
                    b, _, _, rest = plans[i]
                    rest_lr[i] = (b.left[rest // len(b.right)],
                                  b.right[rest % len(b.right)])
                sim = cfg.vote == "sim"
                votes = vote_clusters(
                    cfg.vote, [labels_by_block[i] for i in live],
                    [len(plans[i][3]) for i in live], lb, ub,
                    emb_unsampled=[_pair_embs(el_dev, er_dev, *rest_lr[i])
                                   for i in live] if sim else None,
                    emb_sampled=[_pair_embs(el, er, plans[i][1],
                                            plans[i][2])
                                 for i in live] if sim else None,
                    bandwidth=cfg.sim_bandwidth, device=device)

                round_voted = n_undet = 0
                undet_blocks = []
                for pos, i in enumerate(live):
                    b = plans[i][0]
                    ri, rj = rest_lr[i]
                    vr = votes[pos]
                    tt, ff = vr.decided_true, vr.decided_false
                    mask[ri[tt], rj[tt]] = True
                    decided[ri[tt], rj[tt]] = True
                    decided[ri[ff], rj[ff]] = True
                    round_voted += len(tt) + len(ff)
                    if len(vr.undetermined):
                        n_undet += len(vr.undetermined)
                        undet_blocks.append(b)
            n_voted += round_voted
            round_log.append(JoinRound(
                depth=depth, n_blocks=len(plans),
                n_sampled=int(len(batch)), n_voted=round_voted,
                n_undetermined=n_undet))
            rsp.set(n_sampled=int(len(batch)), n_voted=round_voted,
                    n_undetermined=n_undet)
            tr.metrics.inc("driver.rounds")
            tr.metrics.observe("round.wall_s", monotonic() - t_round)

            if not undet_blocks:
                break
            # ---- refine or fall back ----
            depth += 1
            with tr.span("partition", kind="partition", depth=depth,
                         n_blocks=len(undet_blocks)):
                blocks = []
                for b in undet_blocks:
                    sub = ~decided[np.ix_(b.left, b.right)]
                    n_undec = int(sub.sum())
                    if depth > cfg.max_refine or n_undec <= cfg.min_sample:
                        ii, jj = np.nonzero(sub)
                        li, rj = b.left[ii], b.right[jj]
                        lab = oracle(pair_ids(li, rj, nr))
                        mask[li, rj] = lab
                        decided[li, rj] = True
                        n_fallback += len(li)
                    else:
                        blocks.extend(_split_block(b, el, er, cfg, depth,
                                                   init_centroids, device))

    if not decided.all():
        raise RuntimeError(f"join left {int((~decided).sum())} pair(s) "
                           "undecided — refinement invariant violated")
    delta = oracle.stats.delta(before)
    tr.metrics.inc("oracle.calls", delta.n_calls)
    tr.metrics.inc("oracle.input_tokens", delta.input_tokens)
    tr.metrics.inc("oracle.output_tokens", delta.output_tokens)
    tr.metrics.inc("driver.voted", n_voted)
    tr.metrics.inc("driver.fallback", n_fallback)
    return JoinResult(
        pair_mask=mask, n_llm_calls=delta.n_calls,
        input_tokens=delta.input_tokens, output_tokens=delta.output_tokens,
        n_voted=n_voted, n_fallback=n_fallback, refine_rounds=depth,
        total_time_s=monotonic() - t0, round_log=round_log)
