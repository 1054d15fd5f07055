"""ctypes wrappers of the hand-written SimVote kernel (K2 and K3).

One CUDA kernel (``repro_torch/csrc/simvote.cu``) serves both entry points:
the segmented one (K3, replacing ``simvote_scores_segmented_pallas``,
src/repro/kernels/simvote/kernel.py:102) and the single-cluster one (K2,
replacing ``simvote_scores_pallas``, kernel.py:55), which is K3 with C = 1.
Rows stay where the caller put them: the wrapper uploads a block->cluster
table and CSR row offsets instead of re-packing x.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

BLOCK_N = 32  # rows per CUDA block; matches BN in simvote.cu


def _launch(wrapper, x, counts, s_pad, y_pad,
            inv2t2: np.ndarray) -> torch.Tensor:
    """Score on the card; ``wrapper.launches`` counts real launches only."""
    build.require_cuda("simvote", x, s_pad, y_pad)
    for t in (x, s_pad, y_pad):
        if t.dtype != torch.float32:
            raise TypeError(f"simvote takes float32, got {t.dtype}")
    counts = np.asarray(counts, np.int64)
    c, m, d = s_pad.shape
    n = x.shape[0]
    if int(counts.sum()) != n or len(counts) != c or x.shape[1] != d \
            or tuple(y_pad.shape) != (c, m):
        raise ValueError(f"simvote shapes: x {tuple(x.shape)}, counts "
                         f"{counts.tolist()}, s_pad {tuple(s_pad.shape)}, "
                         f"y_pad {tuple(y_pad.shape)}")
    scores = torch.empty(n, dtype=torch.float32, device=x.device)
    nblocks = -(-counts // BLOCK_N)
    n_blocks = int(nblocks.sum())
    if n_blocks == 0 or m == 0:
        return scores.zero_()
    table = np.concatenate([
        np.repeat(np.arange(c, dtype=np.int32), nblocks),       # block -> cluster
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),   # row CSR
        np.concatenate([[0], np.cumsum(nblocks)]).astype(np.int32),  # block CSR
    ]).astype(np.int32)
    table_d = torch.from_numpy(table).to(x.device)
    inv_d = torch.from_numpy(np.asarray(inv2t2, np.float32)).to(x.device)
    base = table_d.data_ptr()
    err = build.library().simvote_segmented(
        x.data_ptr(), base, base + 4 * n_blocks, base + 4 * (n_blocks + c + 1),
        s_pad.data_ptr(), y_pad.data_ptr(), inv_d.data_ptr(),
        scores.data_ptr(), n_blocks, m, d, build.stream_ptr(x.device))
    build.check(err, "simvote_segmented")
    wrapper.launches += 1
    return scores


def simvote_scores_segmented_cuda(x, counts, s_pad, y_pad, taus):
    """All clusters of a round in one launch (contract of
    ``simvote_scores_segmented_ref``)."""
    # 1 / (2 tau^2) in float32, as the segmented TPU wrapper computes it
    t32 = np.asarray(taus, np.float32)
    inv2t2 = (np.float32(1.0) / (np.float32(2.0) * t32 ** 2)).astype(np.float32)
    return _launch(simvote_scores_segmented_cuda, x, counts, s_pad, y_pad,
                   inv2t2)


def simvote_scores_cuda(x, s, y, tau: float):
    """x (N,D), s (M,D), y (M,) -> scores (N,): K3 with one cluster."""
    inv2t2 = np.asarray([1.0 / (2.0 * tau * tau)], np.float32)
    return _launch(simvote_scores_cuda, x, [x.shape[0]], s[None],
                   y.reshape(1, -1).contiguous(), inv2t2)


simvote_scores_segmented_cuda.launches = 0
simvote_scores_cuda.launches = 0
