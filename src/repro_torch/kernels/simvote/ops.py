"""Dispatchers: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  A CUDA tensor never reaches the plain version."""
from __future__ import annotations

from repro_torch.kernels.simvote.kernel import (simvote_scores_cuda,
                                                simvote_scores_segmented_cuda)
from repro_torch.kernels.simvote.ref import (simvote_scores_ref,
                                             simvote_scores_segmented_ref)


def simvote_scores(x, s, y, tau):
    if x.device.type == "cpu":
        return simvote_scores_ref(x, s, y, float(tau))
    return simvote_scores_cuda(x, s, y, float(tau))


def simvote_scores_segmented(x, counts, s_pad, y_pad, taus):
    """Segmented (per-cluster) scoring for a whole round in one dispatch.

    See ``simvote_scores_segmented_ref`` for the argument contract; on the
    card one kernel launch scores every cluster without materializing the
    (N x C*M) weight matrix.
    """
    if x.device.type == "cpu":
        return simvote_scores_segmented_ref(x, counts, s_pad, y_pad, taus)
    return simvote_scores_segmented_cuda(x, counts, s_pad, y_pad, taus)
