"""Batched serving engine: prefill + decode over the model zoo's decoders.

Drives the oracle-LLM side of the CSV pipeline: ``first_token_logits``
serves the semantic filter's yes/no decisions; ``generate`` serves the
example apps, decoding over a KV cache (global attention layers on the
flash-decoding kernel under ``attn_impl="flash"``; Mamba layers carry
their SSM state, MoE layers dispatch each step's token).  Prompts are
grouped into power-of-two length buckets by the same ``BucketBatcher``
as the reference, so an MoE model's capacity and a Mamba layer's state
see a batch's right padding as the reference's do.  Encoder-decoder and
VLM-prefix models take their frames or prefix through ``lm.prefill`` and
``lm.forward``, not through the engine (nor do the reference's).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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

    # --------------------------------------------------------------- decode
    @torch.inference_mode()
    def generate(self, prompts: Sequence[List[int]], max_new: int = 16,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None
                 ) -> List[List[int]]:
        """Greedy/temperature decoding; returns generated ids per prompt.

        ``temperature > 0`` draws Gumbel noise from ``generator``, a
        ``torch.Generator`` on the engine's device (the reference's
        ``jax.random`` stream cannot be reproduced in torch).  Tokens stay
        on the device between steps and come back to the host once per
        batch.
        """
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 needs a torch.Generator on "
                             "the engine's device")
        results: List[List[int]] = [[] for _ in prompts]
        tr = get_tracer()
        for idx, toks, lens in self.batcher.plan(prompts):
            L = toks.shape[1]
            with tr.span("engine_tick", kind="engine_tick", phase="generate",
                         bucket_len=int(L), batch=int(len(idx)),
                         tokens=int(lens.sum()), max_new=int(max_new),
                         attn_impl=self.cfg.attn_impl):
                # the reference's cache length: past 64 new tokens every
                # step writes the last slot (attention_decode's clamp)
                h, cache, _ = lm.prefill_hidden(
                    self.cfg, self.params, self._to_device(toks),
                    max_len=L + 64)
                # next_pos per sequence = its true length (cache rows
                # beyond a prompt's length contain pad K/V — masked by
                # per-seq pos); the logits are those of row lens - 1
                pos = self._to_device(lens)
                rows = torch.arange(len(idx), device=self.device)
                cur = self._sample(lm.hidden_logits(self.cfg, self.params,
                                              h[rows, pos - 1]),
                                   temperature, generator)
                del h
                steps = []
                for _ in range(max_new):
                    steps.append(cur)
                    logits, cache = lm.decode_step(self.cfg, self.params,
                                                   cache, cur, pos)
                    pos = pos + 1
                    cur = self._sample(logits, temperature, generator)
                    self.stats["decode_tokens"] += len(idx)
                if steps:
                    out = torch.stack(steps, dim=1).cpu().numpy()
                    for r, k in enumerate(idx):
                        results[k].extend(int(t) for t in out[r])
            tr.metrics.inc("engine.prefill_tokens", int(lens.sum()))
            tr.metrics.inc("engine.decode_tokens", int(max_new * len(idx)))
            tr.metrics.inc("engine.ticks")
        for k in ("truncated_prompts", "truncated_tokens"):
            self.stats[k] = self.batcher.stats[k]
        return results

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Next ids (B,) on the logits' device; argmax keeps the first
        maximum, as ``np.argmax`` does."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits / temperature + gumbel, dim=-1)
