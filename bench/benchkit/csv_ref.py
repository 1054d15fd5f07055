"""The plain reference of the CSV filter (paper Algorithm 1 with SimVote),
in float64 on the device, with the program's policy: a pre-clustering of
the table (k-means, ``seed``), then rounds of sample -> ask -> vote ->
re-cluster (k-means of the undetermined rows, ``seed + depth``) or, past
``max_recluster`` rounds or at ``min_sample`` rows or fewer, ask every
pending row.  Samples are numpy ``default_rng(seed).choice`` draws in
cluster order; each cluster's bandwidth is the median pairwise distance
of its first 256 samples, as numpy float32 computes it on the host.

Every decision that rounding could turn records a tie: a k-means
assignment or stopping test that a row within ``KMEANS_TIE`` of a
second centroid could change (``kmeans``), a vote score within
``VOTE_TIE`` of a threshold.  The comparison follows the program only up
to the first tie (``Run.followed``): past it, the program's state may
rightly differ.

``matmul="tf32"`` is the control: the distance products of k-means and
SimVote rounded to TF32 (10-bit mantissas), as the card's tensor cores
take float32 with TF32 on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchkit.spec import sample_size

KMEANS_TIE = 1e-2  # squared distance; the program's float32 error is ~1e-3
VOTE_TIE = 1e-5    # score; the program's float32 error is ~1e-6


def plusplus(seed: int, x: np.ndarray, k: int) -> np.ndarray:
    """k-means++ seeding on a CPU ``torch.Generator``: the seeder the
    reference uses (a copy of the program's default seeder,
    frozen here)."""
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


def _tf32(x):
    """float32 rounded to TF32's 10-bit mantissa."""
    return ((x.float().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def _dist2(x, c, matmul: str):
    """Squared distances (N, K) in float64 by the norm expansion."""
    if matmul == "tf32":
        prod = (_tf32(x) @ _tf32(c).T).double()
    else:
        prod = x @ c.T
    return (x * x).sum(-1, keepdim=True) - 2 * prod + (c * c).sum(-1)[None]


def kmeans(seed: int, x, x_host, k: int, max_iters: int, seeder, matmul,
           tol: float = 1e-4):
    """Lloyd's algorithm as the program runs it -> (assign (N,) numpy,
    tie: bool).

    A row within ``KMEANS_TIE`` of a second centroid may go either way in
    the program.  Moving one row moves each of two centroids by at most
    R / n_min (R the largest row-to-centroid distance, n_min the smallest
    cluster), and so any margin by at most 4 R^2 / n_min: that much slack,
    times the rows that may have moved, widens the next iteration's test.
    A tie in the final assignment, or a stopping test within the slack of
    its tolerance, is a tie of the run."""
    cents = torch.as_tensor(np.asarray(seeder(seed, x_host, k)),
                            dtype=torch.float64, device=x.device)
    slack = shift_slack = 0.0
    it, moving = 0, True
    while True:
        d = _dist2(x, cents, matmul)
        two = torch.topk(d, min(2, k), dim=1, largest=False).values
        near = (int(torch.sum(two[:, 1] - two[:, 0] < KMEANS_TIE + slack))
                if k > 1 else 0)
        assign = torch.argmin(d, 1)
        if not (it < max_iters and moving):
            return assign.cpu().numpy(), near > 0
        onehot = torch.nn.functional.one_hot(assign, k).double()
        counts = onehot.sum(0)
        new = torch.where(counts[:, None] > 0,
                          (onehot.T @ x) / counts.clamp(min=1)[:, None], cents)
        worst = torch.argmax(two[:, 0])
        new = torch.where(counts[:, None] == 0, x[worst][None], new)
        r2 = float(d.max().clamp(min=0))
        n_min = max(1.0, float(counts.min()))
        slack = near * 4 * r2 / n_min
        shift_slack = near * (r2 ** 0.5) / n_min
        shift = float(torch.max(torch.sum((new - cents) ** 2, -1)))
        if abs(shift ** 0.5 - tol ** 0.5) <= max(shift_slack,
                                                 1e-3 * tol ** 0.5):
            return assign.cpu().numpy(), True
        moving = shift > tol
        cents = new
        it += 1


def bandwidth(emb_sampled: np.ndarray) -> float:
    m = emb_sampled.shape[0]
    if m < 2:
        return 1.0
    sub = emb_sampled[: min(m, 256)]
    d2 = np.sum((sub[:, None, :] - sub[None, :, :]) ** 2, axis=-1)
    med = float(np.median(np.sqrt(d2[np.triu_indices(len(sub), 1)])))
    return max(med, 1e-6)


def simvote(x, s, y, tau: float, matmul: str):
    w = torch.exp(-_dist2(x, s, matmul).clamp(min=0) / (2 * tau * tau))
    return (w @ y) / w.sum(-1).clamp(min=1e-300)


@dataclasses.dataclass
class Run:
    mask: np.ndarray
    calls: list          # ids of each oracle call, in order
    followed: int        # calls made before the first tie
    decided_at: np.ndarray  # call index whose round decided the row (-1: none)
    decisive: np.ndarray    # the row's decision was no tie
    log: list               # per cluster: size, sampled, score, voted, ...


def _rows(emb, ids):
    return emb[torch.as_tensor(ids, device=emb.device)]


def csv_filter(emb, emb_host, labels, assign0, pol: dict, seeder,
               matmul: str = "f64", tie0: bool = False) -> Run:
    """One query over the table.  emb: (N, D) float64 on the device;
    assign0: the pre-clustering (with ``tie0``, whether it had a tie)."""
    n = emb.shape[0]
    lb = pol["lb"]
    ub = 1.0 - lb
    rng = np.random.default_rng(pol["seed"])
    mask = np.zeros(n, bool)
    decided_at = np.full(n, -1)
    decisive = np.ones(n, bool)
    calls: list = []
    log: list = []
    followed = None if not tie0 else 0

    def ask(ids):
        calls.append(ids)
        mask[ids] = labels[ids]
        decided_at[ids] = len(calls) - 1
        return labels[ids]

    def tie():
        nonlocal followed
        if followed is None:
            followed = len(calls)

    queue = [np.nonzero(assign0 == c)[0] for c in range(int(assign0.max()) + 1)]
    queue = [c for c in queue if len(c)]
    depth = 0
    while queue and depth <= pol["max_recluster"]:
        plan = []
        for cl in queue:
            m = len(cl)
            local = rng.choice(m, size=sample_size(m, pol["xi"],
                                                   pol["min_sample"]),
                               replace=False)
            rest = np.ones(m, bool)
            rest[local] = False
            plan.append((cl[local], cl[rest]))
        got = ask(np.concatenate([s for s, _ in plan]))
        k = len(calls) - 1
        off = 0
        undetermined = []
        for s_ids, r_ids in plan:
            y = got[off:off + len(s_ids)]
            off += len(s_ids)
            entry = {"size": len(s_ids) + len(r_ids), "sampled": len(s_ids),
                     "score": float(np.mean(y)), "depth": depth}
            log.append(entry)
            if len(r_ids) == 0:
                entry["outcome"] = "exhausted"
                continue
            sc = simvote(_rows(emb, r_ids), _rows(emb, s_ids),
                         torch.as_tensor(y, dtype=torch.float64,
                                         device=emb.device),
                         bandwidth(emb_host[s_ids]), matmul).cpu().numpy()
            near = (np.abs(sc - lb) < VOTE_TIE) | (np.abs(sc - ub) < VOTE_TIE)
            if near.any():
                tie()
            decisive[r_ids[near]] = False
            yes, no = sc >= ub, sc <= lb
            mask[r_ids[yes]] = True
            mask[r_ids[no]] = False
            decided_at[r_ids[yes | no]] = k
            und = ~(yes | no)
            entry.update(voted=int(np.sum(yes | no)),
                         undetermined=int(np.sum(und)),
                         outcome="recluster" if und.any() else "vote")
            if und.any():
                undetermined.append(r_ids[und])
        if not undetermined:
            break
        pending = np.concatenate(undetermined)
        depth += 1
        if depth > pol["max_recluster"] or len(pending) <= pol["min_sample"]:
            ask(pending)
            break
        sub, t = kmeans(pol["seed"] + depth, _rows(emb, pending),
                        emb_host[pending],
                        min(pol["n_clusters"], len(pending)),
                        pol["kmeans_iters"], seeder, matmul)
        if t:
            tie()
        queue = [pending[sub == c] for c in range(int(sub.max()) + 1)]
        queue = [c for c in queue if len(c)]
    return Run(mask, calls, len(calls) if followed is None else followed,
               decided_at, decisive, log)
