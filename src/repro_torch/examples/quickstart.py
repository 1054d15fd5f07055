"""Quickstart: the lazy Session/Query API end-to-end on a synthetic table.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Demonstrates the canonical ``repro_torch.api`` surface: one Session, lazy
``.filter()`` queries, ``.explain()`` before spending a single oracle call,
``.collect()`` routing (CSV vs. the linear reference baseline), predicate
composition with ``&``/``~``, and run-level session accounting.  The
session's k-means and votes run on the card (``main(device="cpu")`` for
the CPU).
"""
from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import SyntheticOracle
from repro_torch.core.operators import accuracy_f1
from repro_torch.data import make_dataset


def fresh_oracle(ds, q, seed=7):
    return SyntheticOracle(ds.labels[q], flip_prob=0.02, seed=seed,
                           token_lens=ds.token_lens)


def main(device="cuda"):
    print("== CSV semantic filter quickstart (repro_torch.api) ==")
    ds = make_dataset("imdb_review", n=4000, seed=0)
    truth = ds.labels["RV-Q1"]

    sess = Session(policy=ExecutionPolicy(n_clusters=4, xi=0.005),
                   device=device)
    reviews = sess.table(texts=ds.texts, embeddings=ds.embeddings,
                         name="reviews")
    print(f"table: {len(reviews)} tuples; predicate: 'the review is "
          f"positive' (selectivity {truth.mean():.2f})")

    # --- linear reference baseline through the same entry point ---
    ref = reviews.filter(fresh_oracle(ds, "RV-Q1"), name="positive").collect(
        sess.policy.replace(method="reference"))
    acc, f1 = accuracy_f1(ref.mask, truth)
    print(f"\nreference: {ref.n_llm_calls} LLM calls (linear scan), "
          f"acc={acc:.4f} f1={f1:.4f}")
    assert ref.n_llm_calls == len(reviews), "the baseline scans every row"

    # --- CSV with UniVote and SimVote ---
    for method in ["csv", "csv-sim"]:
        r = reviews.filter(fresh_oracle(ds, "RV-Q1"), name="positive") \
                   .collect(sess.policy.replace(method=method))
        acc, f1 = accuracy_f1(r.mask, truth)
        fr = r.raw.results["positive"]
        print(f"{method:8s}: {r.n_llm_calls} LLM calls "
              f"({len(reviews)/r.n_llm_calls:.1f}x fewer), "
              f"{fr.n_voted} voted, {fr.n_fallback} fallback, "
              f"acc={acc:.4f} f1={f1:.4f}, "
              f"recluster_time={fr.recluster_time_s*1e3:.0f}ms")
        assert r.n_llm_calls < len(reviews), f"{method}: no call saved"
        assert fr.n_llm_calls + fr.n_voted == len(reviews), method

    # --- lazy composition + explain: zero oracle calls until collect ---
    print("\n-- composed query: positive AND mentions-acting "
          "(cost-ordered cascade) --")
    q = (reviews.filter(fresh_oracle(ds, "RV-Q1"), name="positive")
         & reviews.filter(fresh_oracle(ds, "RV-Q3"), name="mentions_acting"))
    print(q.explain())
    r = q.collect()
    truth_and = ds.labels["RV-Q1"] & ds.labels["RV-Q3"]
    acc, f1 = accuracy_f1(r.mask, truth_and)
    print(f"collected: {r.n_llm_calls} LLM calls "
          f"(pilot {r.pilot_calls}), order={r.order}, "
          f"acc={acc:.4f} f1={f1:.4f}")

    print(f"\nsession totals: {sess.stats.n_calls} oracle calls, "
          f"{sess.stats.input_tokens} input tokens, "
          f"mean oracle batch {sess.stats.mean_batch_size:.1f}")
    return r


if __name__ == "__main__":
    main()
