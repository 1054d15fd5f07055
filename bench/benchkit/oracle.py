"""The benchmark's oracle: the program's ``ModelOracle`` with the model's
full cost and the table's labels.

Every prompt the CSV driver asks about goes through
``ServingEngine.first_token_logits(prompts, token_ids=(B, 2))``, exactly
as ``ModelOracle`` sends it (same prompt, batcher and kernels); the
(yes, no) logits are kept for the check, and the answer is the label the
generator planted.  Random weights give yes/no answers without meaning,
on which the CSV driver degrades to a linear scan; the planted labels
are cluster-structured, as a real model's answers over real data are.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.oracle import ModelOracle


class LabelOracle(ModelOracle):
    def __init__(self, engine, tokenizer, predicate: str, texts,
                 labels: np.ndarray, routes=None):
        super().__init__(engine, tokenizer, predicate, texts)
        self.labels = labels
        self.routes = routes     # a RouteLog, where the model routes
        self.asked: list = []    # ids of each engine call, in order
        self.logits: list = []   # their (n, 2) yes/no logits
        self.spans: list = []    # the RouteLog batches each call served

    def _evaluate(self, ids):
        a = len(self.routes.batches) if self.routes is not None else 0
        pair = self.engine.first_token_logits(
            self.pack_prompts(ids), token_ids=self.pack_token_ids(len(ids)))
        self.asked.append(np.asarray(ids, np.int64))
        self.logits.append(np.asarray(pair, np.float32))
        self.spans.append((a, len(self.routes.batches)
                           if self.routes is not None else 0))
        return self.labels[ids]
