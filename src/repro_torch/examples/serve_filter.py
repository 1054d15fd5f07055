"""Serve a small backbone and run CSV with a REAL ModelOracle:
embeddings from the encoder, decisions from yes/no logits through the
batched serving engine — the full production path at toy scale.

    PYTHONPATH=src python -m repro_torch.examples.serve_filter

The backbone is the smoke configuration of llama3.1-8b with random
weights from a torch seed, on the card (``main(device="cpu")`` for the
CPU).
"""
import torch

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.configs import smoke_config
from repro_torch.core.oracle import ModelOracle
from repro_torch.data import make_dataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embeddings import EmbeddingModel
from repro_torch.models import lm
from repro_torch.serving import ServingEngine
from repro_torch.utils.device import resolve_device


def main(device="cuda"):
    print("== semantic filter served by a PyTorch backbone ==")
    dev = resolve_device(device)
    ds = make_dataset("imdb_review", n=600, seed=0)

    # model plane: the oracle LLM behind the batched serving engine
    cfg = smoke_config("llama3.1-8b")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    engine = ServingEngine(cfg, params, max_batch=8, device=dev)
    tok = HashTokenizer(cfg.vocab_size)
    oracle = ModelOracle(engine, tok, "the review is positive", ds.texts)

    # data plane: embeddings from the encoder (E5-style, chunked)
    encoder = EmbeddingModel(smoke_config("e5-large"), max_len=32,
                             device=dev)
    emb = encoder.encode(ds.texts)
    print(f"embedded {len(ds.texts)} tuples -> {emb.shape}")

    sess = Session(engine=engine, device=dev)
    table = sess.table(texts=ds.texts, embeddings=emb, name="reviews")
    r = table.filter(oracle, name="positive").collect(
        ExecutionPolicy(method="csv", n_clusters=4, min_sample=25))
    print(f"CSV: {r.n_llm_calls} LLM invocations for {len(ds.texts)} tuples "
          f"({len(ds.texts)/max(1,r.n_llm_calls):.1f}x reduction)")
    print(f"engine stats: {engine.stats}")
    print(f"passed filter: {int(r.mask.sum())} tuples")
    # NOTE: the backbone is untrained — decisions are arbitrary but the
    # entire serving path (batcher -> prefill -> yes/no logits -> voting)
    # is the production one.
    return r


if __name__ == "__main__":
    main()
