"""Baseline semantic-filter algorithms (paper §2.2) for comparison.

- Reference: one oracle call per tuple (Eq. 1) — O(|T|).
- Lotus: proxy-score cascade with learned (tau-, tau+) thresholds.
- BARGAIN: region-wise adaptive sampling with an accuracy target.

Both cascades invoke the *proxy* LLM on every tuple (the linear pass the
paper criticizes); our accounting separates proxy calls from oracle calls
so Fig. 4 analogues can weight them by model cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BaselineResult:
    mask: np.ndarray
    n_oracle_calls: int
    n_proxy_calls: int
    input_tokens: int
    output_tokens: int
    thresholds: tuple = ()
    extra: dict = dataclasses.field(default_factory=dict)


def reference_filter(n: int, oracle) -> BaselineResult:
    before = oracle.stats.n_calls
    labels = oracle(np.arange(n))
    st = oracle.stats
    return BaselineResult(mask=labels, n_oracle_calls=st.n_calls - before,
                          n_proxy_calls=0, input_tokens=st.input_tokens,
                          output_tokens=st.output_tokens)


def lotus_filter(n: int, proxy, oracle, sample_size: int = 200,
                 recall_target: float = 0.9, precision_target: float = 0.9,
                 seed: int = 0) -> BaselineResult:
    """Lotus-style cascade.

    1. proxy scores for ALL tuples (linear proxy pass);
    2. oracle-label a small sample; learn tau+ (precision) and tau-
       (recall) on the sample;
    3. score > tau+ -> True, score < tau- -> False, else oracle.
    Degenerate thresholds (overlapping score bands — the paper's Fig. 1(a)
    pathology) route (almost) everything to the oracle.
    """
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    _, scores = proxy(ids)

    sample = rng.choice(n, size=min(sample_size, n), replace=False)
    sample_labels = oracle(sample)
    s_scores = scores[sample]

    # tau+: smallest threshold with precision >= target on the sample
    order = np.argsort(-s_scores)
    sorted_lab = sample_labels[order]
    prec = np.cumsum(sorted_lab) / (np.arange(len(order)) + 1)
    ok = np.nonzero(prec >= precision_target)[0]
    tau_plus = s_scores[order][ok[-1]] if len(ok) else np.inf
    # tau-: largest threshold keeping recall >= target (few positives below)
    order2 = np.argsort(s_scores)
    sorted_lab2 = sample_labels[order2]
    pos_total = max(1, int(sample_labels.sum()))
    lost = np.cumsum(sorted_lab2) / pos_total
    ok2 = np.nonzero(lost <= 1 - recall_target)[0]
    tau_minus = s_scores[order2][ok2[-1]] if len(ok2) else -np.inf

    mask = np.zeros(n, dtype=bool)
    mask[scores > tau_plus] = True
    uncertain = ids[(scores <= tau_plus) & (scores >= tau_minus)]
    uncertain = np.setdiff1d(uncertain, sample, assume_unique=False)
    if len(uncertain):
        mask[uncertain] = oracle(uncertain)
    mask[sample] = sample_labels

    st, pt = oracle.stats, proxy.stats
    return BaselineResult(
        mask=mask, n_oracle_calls=st.n_calls, n_proxy_calls=pt.n_calls,
        input_tokens=st.input_tokens + pt.input_tokens,
        output_tokens=st.output_tokens + pt.output_tokens,
        thresholds=(float(tau_minus), float(tau_plus)),
        extra={"n_uncertain": int(len(uncertain))})


def bargain_filter(n: int, proxy, oracle, accuracy_target: float = 0.85,
                   tolerance: float = 0.05, n_regions: int = 20,
                   samples_per_region: int = 30, seed: int = 0
                   ) -> BaselineResult:
    """BARGAIN-style region-wise adaptive cascade.

    Partition tuples into proxy-score regions; from the highest region down,
    sample + oracle-test whether trusting the proxy in that region meets the
    accuracy target (one-sided binomial check with tolerance); stop at the
    first failing region; everything below the stop threshold goes to the
    oracle.
    """
    rng = np.random.default_rng(seed)
    ids = np.arange(n)
    proxy_labels, scores = proxy(ids)

    edges = np.quantile(scores, np.linspace(0, 1, n_regions + 1))
    region = np.clip(np.searchsorted(edges, scores, side="right") - 1,
                     0, n_regions - 1)

    mask = np.zeros(n, dtype=bool)
    trusted = np.zeros(n, dtype=bool)
    stop_region = n_regions  # regions >= stop trusted
    for r in range(n_regions - 1, -1, -1):
        members = ids[region == r]
        if len(members) == 0:
            continue
        take = min(samples_per_region, len(members))
        s = rng.choice(members, size=take, replace=False)
        lab = oracle(s)
        agree = float(np.mean(lab == proxy_labels[s]))
        # one-sided check with tolerance
        if agree + tolerance >= accuracy_target:
            stop_region = r
            mask[s] = lab
            trusted[members] = True
            mask[np.setdiff1d(members, s)] = proxy_labels[np.setdiff1d(members, s)]
        else:
            mask[s] = lab
            break
    rest = ids[(~trusted) & (region < stop_region)]
    # exclude already-sampled (oracle memo makes re-calls free, but be exact)
    if len(rest):
        mask[rest] = oracle(rest)

    st, pt = oracle.stats, proxy.stats
    return BaselineResult(
        mask=mask, n_oracle_calls=st.n_calls, n_proxy_calls=pt.n_calls,
        input_tokens=st.input_tokens + pt.input_tokens,
        output_tokens=st.output_tokens + pt.output_tokens,
        thresholds=(int(stop_region),),
        extra={"n_rest": int(len(rest))})
