"""Plain PyTorch version of SimVote scoring (paper Eq. 4), plain and
segmented."""
from __future__ import annotations

import numpy as np
import torch


def simvote_scores_ref(x, s, y, tau: float):
    """x (N,D) unsampled, s (M,D) sampled, y (M,) in {0,1} -> scores (N,).

    score_i = sum_j w_ij y_j / sum_j w_ij,  w_ij = exp(-||x_i - s_j||^2 / 2 tau^2)
    """
    xf, sf = x.float(), s.float()
    d2 = (torch.sum(xf * xf, -1, keepdim=True)
          - 2.0 * xf @ sf.T + torch.sum(sf * sf, -1)[None, :])  # (N,M)
    w = torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * tau * tau))
    num = w @ y.float()
    den = torch.sum(w, dim=-1)
    return num / torch.clamp(den, min=1e-30)


def simvote_scores_segmented_ref(x, counts, s_pad, y_pad, taus):
    """Segmented SimVote scoring over all clusters of a round.

    x       (N, D)   unsampled rows, grouped by cluster (counts[c] rows each)
    counts  (C,)     host ints — rows of x belonging to each cluster
    s_pad   (C, M, D) per-cluster samples, zero-padded along M
    y_pad   (C, M)   labels in {0, 1}; -1 marks M-padding
    taus    (C,)     per-cluster Gaussian bandwidth
    -> scores (N,)

    Semantics = C independent ``simvote_scores_ref`` calls on each
    cluster's own (unpadded) slice.
    """
    counts = np.asarray(counts, np.int64)
    taus = np.asarray(taus, np.float64)
    out, start = [], 0
    for ci, n_c in enumerate(counts):
        if n_c == 0:
            continue
        m_c = int(torch.sum(y_pad[ci] >= 0.0))
        out.append(simvote_scores_ref(x[start:start + n_c],
                                      s_pad[ci, :m_c], y_pad[ci, :m_c],
                                      float(taus[ci])))
        start += int(n_c)
    if not out:
        return torch.zeros((0,), dtype=torch.float32, device=x.device)
    return torch.cat(out)
