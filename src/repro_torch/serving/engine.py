"""Batched serving engine: prefill over the ported model subset.

Drives the oracle-LLM side of the CSV pipeline: ``first_token_logits``
serves the semantic filter's yes/no decisions.  Prompts are grouped into
power-of-two length buckets by the same ``BucketBatcher`` as the
reference.  ``generate`` and the decode path are a later slice of the port.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import get_tracer
from repro_torch.serving.batcher import BucketBatcher
from repro_torch.utils.device import resolve_device


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 16,
                 pad_id: int = 0, *, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batcher = BucketBatcher(max_batch=max_batch, pad_id=pad_id)
        # batch_sizes keeps only a recent window (debug visibility); the
        # mean uses O(1) cumulative counters so a long-running server never
        # grows without bound
        self.stats = {"prefill_tokens": 0, "decode_tokens": 0, "batches": 0,
                      "batched_prompts": 0, "batch_sizes": [],
                      # mirrored from the batcher so silent prompt-head
                      # loss is visible where serving stats are read
                      "truncated_prompts": 0, "truncated_tokens": 0}
    _BATCH_SIZE_WINDOW = 1024

    @property
    def mean_batch_size(self) -> float:
        """Mean prompts per device batch — grows toward ``max_batch`` when
        callers (the CSV round executor) submit cross-cluster round batches
        instead of per-cluster trickles."""
        return self.stats["batched_prompts"] / max(1, self.stats["batches"])

    def _to_device(self, a: np.ndarray, dtype=torch.long) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def first_token_logits(self, prompts: Sequence[List[int]],
                           token_ids=None) -> np.ndarray:
        """Logits at each prompt's last position.

        Without ``token_ids``: the full (n_prompts, padded_vocab) float32
        matrix.  With ``token_ids`` — (T,) shared across prompts or
        (n_prompts, T) per prompt — only those T logits per prompt come
        back to the host ((n_prompts, T)); the yes/no oracle fast path
        that never materializes the vocab axis.
        """
        if token_ids is not None:
            token_ids = np.asarray(token_ids, np.int32)
        n_tok = (self.cfg.padded_vocab if token_ids is None
                 else token_ids.shape[-1])
        out = np.zeros((len(prompts), n_tok), np.float32)
        tr = get_tracer()
        for idx, toks, lens in self.batcher.plan(prompts):
            with tr.span("engine_tick", kind="engine_tick", phase="prefill",
                         bucket_len=int(toks.shape[1]), batch=int(len(idx)),
                         tokens=int(lens.sum()),
                         attn_impl=self.cfg.attn_impl):
                toks_d = self._to_device(toks)
                if token_ids is None:
                    logits, _ = lm.forward(self.cfg, self.params, toks_d)
                    rows = torch.arange(len(idx), device=self.device)
                    last = logits[rows, self._to_device(lens - 1)]
                else:
                    tids = (token_ids if token_ids.ndim == 1
                            else token_ids[idx])
                    last = lm.first_logits_select(
                        self.cfg, self.params, toks_d, self._to_device(lens),
                        self._to_device(tids))
                out[idx] = last.cpu().numpy()
            self.stats["prefill_tokens"] += int(lens.sum())
            self.stats["batches"] += 1
            self.stats["batched_prompts"] += int(len(idx))
            self.stats["batch_sizes"].append(int(len(idx)))
            del self.stats["batch_sizes"][:-self._BATCH_SIZE_WINDOW]
            tr.metrics.inc("engine.prefill_tokens", int(lens.sum()))
            tr.metrics.inc("engine.ticks")
            tr.metrics.observe("engine.batch_size", int(len(idx)),
                               bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        tr.metrics.set_info("kernel.attn_impl", self.cfg.attn_impl)
        tr.metrics.set("engine.bucket_fill", self.batcher.fill_ratio)
        for k in ("truncated_prompts", "truncated_tokens"):
            self.stats[k] = self.batcher.stats[k]
        return out
