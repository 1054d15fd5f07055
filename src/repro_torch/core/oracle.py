"""LLM oracle interfaces: M(t, e) -> {True, False} plus accounting.

Two families:
- SyntheticOracle: ground-truth labels + a calibrated Bernoulli flip channel
  modelling LLM non-determinism (the paper runs temperature 0.7).  Used for
  statistically controlled benchmarks (Tables 2-5 analogues).
- ModelOracle: a real PyTorch backbone served through repro_torch.serving;
  the binary decision is the yes/no logit margin at the first generated
  position — the batched equivalent of the paper's output-token parse.

All oracles count calls and tokens (the paper's efficiency metrics) and
memoize by tuple id — the memo doubles as the §3.1 update cache and makes
the CSV driver restartable (fault tolerance).
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class OracleStats:
    n_calls: int = 0
    n_cached: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    # size of every *evaluated* batch (memo hits excluded) — the round
    # executor's key efficiency signal: one entry per model invocation
    batch_sizes: list = dataclasses.field(default_factory=list)

    def clone(self):
        return dataclasses.replace(self, batch_sizes=list(self.batch_sizes))

    def delta(self, before: "OracleStats") -> "OracleStats":
        """Accounting attributable to work since ``before`` (a clone)."""
        return OracleStats(
            n_calls=self.n_calls - before.n_calls,
            n_cached=self.n_cached - before.n_cached,
            input_tokens=self.input_tokens - before.input_tokens,
            output_tokens=self.output_tokens - before.output_tokens,
            batch_sizes=self.batch_sizes[len(before.batch_sizes):],
        )

    def merge(self, other: "OracleStats") -> "OracleStats":
        """Fold another stats object (typically a delta) into this one —
        the session-level run aggregate of the API layer (a later slice)."""
        self.n_calls += other.n_calls
        self.n_cached += other.n_cached
        self.input_tokens += other.input_tokens
        self.output_tokens += other.output_tokens
        self.batch_sizes.extend(other.batch_sizes)
        return self

    @property
    def mean_batch_size(self) -> float:
        return (float(np.mean(self.batch_sizes))
                if self.batch_sizes else 0.0)

    def metrics_view(self) -> dict:
        """Unified-name view for ``MetricsRegistry.sync_from`` (this
        dataclass stays the per-oracle accounting of record; the view is
        read-only — see docs/observability.md)."""
        return {
            "oracle.calls": self.n_calls,
            "oracle.cached": self.n_cached,
            "oracle.input_tokens": self.input_tokens,
            "oracle.output_tokens": self.output_tokens,
            "oracle.mean_batch_size": self.mean_batch_size,
        }


@dataclasses.dataclass
class StatsScope:
    """Holder filled at ``BaseOracle.scope()`` exit with the block's delta."""
    delta: Optional[OracleStats] = None


class BaseOracle:
    """Batched, memoized oracle."""

    def __init__(self):
        self.stats = OracleStats()
        self._memo: dict[int, bool] = {}
        # durability hook: called as memo_hook(ids, labels) after every
        # fresh-evaluation commit (the service's session log records them
        # so a restarted session replays them at zero oracle cost)
        self.memo_hook = None

    @contextlib.contextmanager
    def scope(self):
        """Attribute accounting to one plan node / pilot probe.

        Yields a ``StatsScope`` whose ``.delta`` is set on exit to the calls
        and tokens spent inside the with-block — the plan executor uses one
        scope per expression node so a shared or memoized oracle never
        inflates another node's efficiency metrics.
        """
        before = self.stats.clone()
        holder = StatsScope()
        try:
            yield holder
        finally:
            holder.delta = self.stats.delta(before)

    def _evaluate(self, ids: np.ndarray) -> np.ndarray:  # -> bool array
        raise NotImplementedError

    def _tokens_of(self, ids: np.ndarray) -> int:
        return int(len(ids)) * 64  # overridden where real text exists

    def _memo_split(self, ids):
        """Resolve memo hits; return (out, missing, missing_pos).

        ``out`` has hits filled in (misses still False); ``missing`` are the
        ids needing a model evaluation, ``missing_pos`` their positions.
        Counts cache hits exactly as ``__call__`` always has.
        """
        ids = np.asarray(ids, dtype=np.int64)
        out = np.zeros(len(ids), dtype=bool)
        missing, missing_pos = [], []
        for pos, i in enumerate(ids):
            if int(i) in self._memo:
                out[pos] = self._memo[int(i)]
                self.stats.n_cached += 1
            else:
                missing.append(int(i))
                missing_pos.append(pos)
        return out, missing, missing_pos

    def _memo_commit(self, out, missing, missing_pos, labels) -> np.ndarray:
        """Fold evaluated labels back: memo writes + stats, as ``__call__``."""
        mids = np.asarray(missing, dtype=np.int64)
        for i, lab in zip(missing, labels):
            self._memo[i] = bool(lab)
        out[missing_pos] = labels
        self.stats.n_calls += len(missing)
        self.stats.input_tokens += self._tokens_of(mids)
        self.stats.output_tokens += len(missing)  # 1 decision token each
        self.stats.batch_sizes.append(len(missing))
        if self.memo_hook is not None and len(missing):
            self.memo_hook(mids, np.asarray(labels, dtype=bool))
        return out

    def __call__(self, ids) -> np.ndarray:
        out, missing, missing_pos = self._memo_split(ids)
        if missing:
            labels = self._evaluate(np.asarray(missing, dtype=np.int64))
            out = self._memo_commit(out, missing, missing_pos, labels)
        return out

    # --- persistence (fault tolerance / §3.1 update cache) ---
    def memo_snapshot(self) -> dict:
        return dict(self._memo)

    def memo_restore(self, snap: dict):
        self._memo.update({int(k): bool(v) for k, v in snap.items()})

    def memo_invalidate(self, ids) -> int:
        """Drop per-id memo entries whose tuple *content* changed (§3.1
        updates): a memo keyed by tuple id is only valid while the tuple's
        payload is.  ``TableHandle.update`` calls this for every oracle the
        session has seen touch the table.  Returns entries dropped."""
        dropped = 0
        for i in np.asarray(ids, dtype=np.int64):
            if self._memo.pop(int(i), None) is not None:
                dropped += 1
        return dropped

    def memo_clear(self) -> int:
        """Drop the whole per-id memo.  Needed for *pair* oracles after a
        table mutation: pair ids ``i * len(right) + j`` reindex when the
        right table grows, so no per-id invalidation can be correct."""
        n = len(self._memo)
        self._memo.clear()
        return n


class SyntheticOracle(BaseOracle):
    def __init__(self, labels: np.ndarray, flip_prob: float = 0.0,
                 seed: int = 0, token_lens: Optional[np.ndarray] = None):
        super().__init__()
        self.labels = np.asarray(labels, dtype=bool)
        self.flip_prob = float(flip_prob)
        self.rng = np.random.default_rng(seed)
        self.token_lens = token_lens

    def _evaluate(self, ids):
        lab = self.labels[ids].copy()
        if self.flip_prob > 0:
            flips = self.rng.random(len(ids)) < self.flip_prob
            lab ^= flips
        return lab

    def _tokens_of(self, ids):
        if self.token_lens is None:
            return super()._tokens_of(ids)
        return int(np.sum(self.token_lens[ids]))


class ProxyModel:
    """Cascade proxy (Lotus/BARGAIN baselines): label + confidence score.

    Synthetic variant: score = calibated-or-miscalibrated sigmoid of the
    true margin.  ``concentration`` < 1 reproduces the paper's Fig. 1(a)
    pathology (scores bunched in a narrow band, weak label separation).
    """

    def __init__(self, labels: np.ndarray, quality: float = 1.5,
                 center: float = 0.5, concentration: float = 1.0,
                 seed: int = 1, token_lens: Optional[np.ndarray] = None):
        self.labels = np.asarray(labels, dtype=bool)
        rng = np.random.default_rng(seed)
        margin = (self.labels.astype(np.float64) * 2 - 1) * quality
        noise = rng.normal(0, 1.0, len(self.labels))
        raw = 1.0 / (1.0 + np.exp(-(margin + noise)))
        self.scores = center + (raw - 0.5) * concentration
        self.scores = np.clip(self.scores, 0.0, 1.0)
        self.stats = OracleStats()
        self.token_lens = token_lens

    def __call__(self, ids) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, dtype=np.int64)
        self.stats.n_calls += len(ids)
        if self.token_lens is not None:
            self.stats.input_tokens += int(np.sum(self.token_lens[ids]))
        else:
            self.stats.input_tokens += len(ids) * 64
        self.stats.output_tokens += len(ids)
        return self.scores[ids] > 0.5, self.scores[ids]


class ModelOracle(BaseOracle):
    """Oracle backed by a PyTorch backbone via the serving engine.

    decision(t) = logit("yes") > logit("no") at the first generated position
    for the prompt [instruction; predicate; tuple-text].
    """

    def __init__(self, engine, tokenizer, predicate: str,
                 texts: Sequence[str], yes_id: Optional[int] = None,
                 no_id: Optional[int] = None,
                 instruction: str = "Answer yes or no: does the text satisfy "
                                    "the condition?"):
        super().__init__()
        self.engine = engine
        self.tok = tokenizer
        self.predicate = predicate
        self.texts = texts
        self.instruction = instruction
        self.yes_id = yes_id if yes_id is not None else tokenizer.token_id("yes")
        self.no_id = no_id if no_id is not None else tokenizer.token_id("no")
        self._tok_cache: dict[int, list[int]] = {}

    def _prompt_ids(self, i: int):
        if i not in self._tok_cache:
            text = f"{self.instruction}\ncondition: {self.predicate}\ntext: {self.texts[i]}\nanswer:"
            self._tok_cache[i] = self.tok.encode(text)
        return self._tok_cache[i]

    def _evaluate(self, ids):
        # narrow fast path: only the (yes, no) logit pair leaves the
        # device.  Per-prompt (B, 2) token ids — the same einsum shape the
        # packed cross-oracle wave uses, so packed and per-oracle dispatch
        # produce bit-identical logits.
        pair = self.engine.first_token_logits(
            self.pack_prompts(ids), token_ids=self.pack_token_ids(len(ids)))
        return self.pack_labels(pair)

    def _tokens_of(self, ids):
        return int(sum(len(self._prompt_ids(int(i))) for i in ids))

    # --- cross-oracle packing protocol (service scheduler) ---
    # Oracles sharing ``pack_engine`` can have their prompts evaluated in
    # one engine wave: the scheduler concatenates ``pack_prompts`` outputs,
    # calls ``pack_engine.first_token_logits(prompts, token_ids=(B, 2))``
    # once, and hands each oracle its slice back through ``pack_labels``.
    @property
    def pack_engine(self):
        return self.engine

    def pack_prompts(self, ids):
        return [self._prompt_ids(int(i)) for i in ids]

    def pack_token_ids(self, n: int) -> np.ndarray:
        return np.tile(np.asarray([self.yes_id, self.no_id], np.int32),
                       (n, 1))

    def pack_labels(self, pair_logits) -> np.ndarray:
        return np.asarray(pair_logits[:, 0] > pair_logits[:, 1])


# --------------------------------------------------------------------------
# Cross-oracle packed evaluation: one engine wave per (tick, length-bucket)
# across every oracle sharing an engine — the service scheduler's fused
# serving path.  Per-oracle memo/stats accounting is byte-identical to
# calling each oracle directly (same _memo_split/_memo_commit helpers).
# --------------------------------------------------------------------------
def evaluate_packed(requests, pack: bool = True):
    """Evaluate ``[(oracle, ids), ...]`` with cross-oracle prompt packing.

    Oracles exposing the pack protocol (``pack_engine``/``pack_prompts``/
    ``pack_labels`` — ``ModelOracle``) and sharing an engine contribute
    their memo-missing prompts to ONE ``first_token_logits`` wave; the
    engine's bucket batcher length-buckets them across oracles and results
    scatter back per ``(oracle, ids)`` slice.  Other oracles evaluate
    normally, in request order.  A request whose oracle appears more than
    once in the wave defers its later occurrences to a follow-up pass, so
    memoization sees the same order a serial drain would produce.

    Returns ``(outcomes, info)``: ``outcomes[i]`` is the label array or the
    exception that request hit; ``info`` holds ``tokens`` (oracle input +
    decision tokens spent) and ``truncated`` (prompts the engine batcher
    left-truncated during this call).
    """
    outcomes: list = [None] * len(requests)
    info = {"tokens": 0, "truncated": 0}
    remaining = list(enumerate(requests))
    while remaining:
        seen_oracles: set = set()
        next_pass = []
        packable: dict = {}   # id(engine) -> [(idx, oracle, split), ...]
        engines: dict = {}
        for idx, (oracle, ids) in remaining:
            if id(oracle) in seen_oracles:
                next_pass.append((idx, (oracle, ids)))
                continue
            seen_oracles.add(id(oracle))
            engine = getattr(oracle, "pack_engine", None) if pack else None
            if engine is None:
                try:
                    before = oracle.stats.clone()
                    outcomes[idx] = oracle(np.asarray(ids))
                    d = oracle.stats.delta(before)
                    info["tokens"] += d.input_tokens + d.output_tokens
                except BaseException as e:
                    outcomes[idx] = e
                continue
            split = oracle._memo_split(ids)
            engines[id(engine)] = engine
            packable.setdefault(id(engine), []).append((idx, oracle, split))
        for ekey, group in packable.items():
            engine = engines[ekey]
            prompts, tok_rows = [], []
            for _, oracle, (_, missing, _) in group:
                prompts.extend(oracle.pack_prompts(missing))
                tok_rows.append(oracle.pack_token_ids(len(missing)))
            if prompts:
                trunc0 = engine.batcher.stats["truncated_prompts"]
                try:
                    pair = engine.first_token_logits(
                        prompts, token_ids=np.concatenate(tok_rows))
                except BaseException as e:
                    for idx, _, _ in group:
                        outcomes[idx] = e
                    continue
                info["truncated"] += (
                    engine.batcher.stats["truncated_prompts"] - trunc0)
            k = 0
            for idx, oracle, (out, missing, missing_pos) in group:
                if missing:
                    labels = oracle.pack_labels(pair[k:k + len(missing)])
                    k += len(missing)
                    out = oracle._memo_commit(out, missing, missing_pos,
                                              labels)
                    info["tokens"] += (oracle._tokens_of(
                        np.asarray(missing, np.int64)) + len(missing))
                outcomes[idx] = out
        remaining = next_pass
    return outcomes, info


# --------------------------------------------------------------------------
# Round dispatch: the executor submits one cross-cluster batch per wave and
# collects the labels later, so oracle prefill for wave k+1 can overlap the
# device voting of wave k (``pipeline_depth`` > 1 in the CSV driver).
# Both dispatchers return a concurrent.futures.Future.
# --------------------------------------------------------------------------
class SyncOracleDispatcher:
    """Evaluates at submit time — the zero-overlap default (depth 1)."""

    def __init__(self, oracle):
        self.oracle = oracle

    def submit(self, ids) -> Future:
        f = Future()
        try:
            f.set_result(self.oracle(ids))
        except BaseException as e:  # propagate at result()
            f.set_exception(e)
        return f

    def close(self):
        pass


class AsyncOracleDispatcher:
    """Single worker thread, strict FIFO: batches are evaluated in submission
    order, so memoization and any stateful oracle RNG (SyntheticOracle's flip
    stream) behave bit-identically to synchronous dispatch.

    ``oracle`` may be omitted when every ``submit`` names its own — the
    multi-oracle form the service scheduler uses to drive one merged
    cross-query dispatch through a single FIFO lane (per-oracle evaluation
    order is then exactly submission order, preserving each query's
    memo/flip-stream state)."""

    def __init__(self, oracle=None):
        self.oracle = oracle
        self._pool = ThreadPoolExecutor(max_workers=1)

    def submit(self, ids, oracle=None) -> Future:
        target = oracle if oracle is not None else self.oracle
        if target is None:
            raise ValueError("dispatcher built without a default oracle; "
                             "pass oracle= to submit()")
        return self._pool.submit(target, np.asarray(ids))

    def submit_call(self, fn, *args) -> Future:
        """Queue an arbitrary callable on the same FIFO lane — the service
        scheduler submits one packed *wave* per call so prefill of wave
        k+1 can overlap host-side voting on wave k's parked tasks."""
        return self._pool.submit(fn, *args)

    def close(self):
        self._pool.shutdown(wait=True)
