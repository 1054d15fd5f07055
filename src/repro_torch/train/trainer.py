"""Train step: loss, grad, microbatched accumulation, optional compression."""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import partition
from repro_torch.distributed.api import partitioned
from repro_torch.distributed.partition import by_rule
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train.grad_compression import compress_grads
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.utils.tree import tree_leaves_with_path, tree_map


def _ce_sum(cfg, params, hc, tc, mc):
    """Summed masked cross entropy of one chunk: float32 log-softmax over
    ``lm.hidden_logits``.  A masked target (< 0) reads class 0 and is
    multiplied by 0, as the reference's wrapped index is."""
    tl = _logprob(lm.hidden_logits(cfg, params, hc), tc.clamp(min=0).long())
    return -torch.sum(tl * mc)


@by_rule(partition.logprob)
def _logprob(logits, t):
    """log_softmax(logits)[..., t]: each position's log-probability of its
    target."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, t[..., None])[..., 0]


def _ce_from_hidden(cfg, params, h, targets, chunk: int):
    """CE over final hidden states; chunked along S when ``0 < chunk < S``
    and chunk divides S, each chunk under activation checkpointing, so the
    (B, S, V) logits never exist (they are recomputed, chunk by chunk, in
    the backward), as the reference's ``jax.checkpoint`` over its scan.
    The chunks' sums add up in float32 in order."""
    S = h.shape[1]
    mask = (targets >= 0).to(torch.float32)
    ce = partial(_ce_sum, cfg, params)
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        total = ce(h, targets, mask)
    else:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            args = (h[:, sl], targets[:, sl], mask[:, sl])
            total = total + (checkpoint(ce, *args, use_reentrant=False)
                             if torch.is_grad_enabled() else ce(*args))
    return total / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, aux_weight: float = 0.01):
    """Causal-LM cross entropy (fp32 log-softmax; sequence-chunked) plus
    ``aux_weight`` times the MoE load-balance aux -> (loss, {ce, aux}).
    A VLM's prefix positions carry no target and are dropped first."""
    h, aux = lm.forward_hidden(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"))
    P = cfg.num_prefix_embeds
    if P:
        h = h[:, P:]
    loss = _ce_from_hidden(cfg, params, h, batch["targets"],
                           getattr(cfg, "loss_chunk", 0))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _grads_of(cfg, params, batch):
    """(loss, metrics, grads): grads in each parameter's type, zeros for
    a parameter the loss does not reach (as ``jax.grad`` gives)."""
    leaves = [p for _, p in tree_leaves_with_path(params)]
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    loss, metrics = loss_fn(cfg, tree_map(lambda _: next(it), params), batch)
    got = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, got))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, oc: OptConfig, microbatches: int = 1,
                    compression: Optional[str] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), a plain function; ``batch`` holds tensors on the
    parameters' device.

    - microbatches > 1: gradient accumulation over batch splits, float32
      sums divided by the count (bounds activation memory independently
      of global batch); the metrics are then loss, grad_norm and lr, as
      the reference's.
    - compression: None | "int8" | "topk" — gradient compression applied
      before the update.

    DTensor parameters and state (``distributed.api.distribute_tree``)
    make it the partitioned step: every operation runs on its rank's
    shards, with the collectives DTensor's placements call for.
    """

    def train_step(params, opt_state, batch):
        with partitioned(params):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            gsum = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, _, g = _grads_of(cfg, params, mb)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {}
        else:
            loss, metrics, grads = _grads_of(cfg, params, batch)

        if compression:
            grads = compress_grads(grads, method=compression)

        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, oc)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step
