#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):

1. build    nvcc builds every kernel from src/repro_torch/csrc into build/.
2. kernels  each CUDA kernel (K1 k-means assignment, K2/K3 SimVote, K4
            flash prefill) against its plain PyTorch version on the card at
            the main path's shapes, with its time, the plain version's
            time, a library yardstick where one exists and the card's
            least time for the same work (its bound).
3. data     the CSV filter over make_dataset("imdb_review", n=50,000,
            dim=1024) with a SyntheticOracle, round and sequential
            executors, vote="sim"; then a small table on the card and on
            the CPU (plain versions), which must give equal runs.
4. model    the same filter over n=4,096 tuples with a ModelOracle served
            by a random-weight llama3.1-8b at full width and depth (bf16,
            attn_impl="flash") through ServingEngine(max_batch=64); then K4
            against its plain version at every (batch, bucket) shape the
            engine served, and the served logits against plain attention.

Each kernel wrapper counts its launches.  There are three main-path runs:
the round executor, the sequential executor and the model path.  The counts
are set to 0 just before each and read just after it, and each run must
launch its own kernels and no other (round: K1, K3; sequential: K1, K2;
model: K1, K3 and K4 = 32 x the engine's batches).  Checks against plain
versions run outside those windows.  In the kernels' JSON record,
"launches" is the sum over the three runs and "launches_by_path" splits it.
The second-to-last lines are that record and the card's name and power
limit; the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12      # H100 SXM device memory, bytes/s
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores, bf16 tensor
N_DATA, DIM, N_MODEL = 50_000, 1024, 4096


def log(*args):
    print(*args, flush=True)


def bound(nbytes: float, ops: float, dtype: str):
    """(least ms, "bytes" | "operations") on an H100 SXM at full power."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.csv_filter import CSVConfig, semantic_filter
    from repro_torch.core.oracle import ModelOracle, SyntheticOracle
    from repro_torch.core.voting import default_bandwidth
    from repro_torch.data import HashTokenizer, make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
    from repro_torch.kernels.kmeans.ref import assign_clusters_ref
    from repro_torch.kernels.simvote.kernel import (
        simvote_scores_cuda, simvote_scores_segmented_cuda)
    from repro_torch.kernels.simvote.ref import (simvote_scores_ref,
                                                 simvote_scores_segmented_ref)
    from repro_torch.models import lm
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.serving import ServingEngine
    from repro_torch.utils.timing import cuda_event_ms, monotonic

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build
    t0 = monotonic()
    build.library()
    log(f"[build] kernels built and loaded in {monotonic() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())

    counters = {"kmeans_assign": assign_clusters_cuda,
                "simvote_scores": simvote_scores_cuda,
                "simvote_scores_segmented": simvote_scores_segmented_cuda,
                "flash_attention": flash_attention_cuda}
    record = {
        "kmeans_assign": {
            "source": "src/repro_torch/csrc/kmeans_assign.cu",
            "replaces": "src/repro/kernels/kmeans/kernel.py:37"},
        "simvote_scores": {
            "source": "src/repro_torch/csrc/simvote.cu",
            "replaces": "src/repro/kernels/simvote/kernel.py:55"},
        "simvote_scores_segmented": {
            "source": "src/repro_torch/csrc/simvote.cu",
            "replaces": "src/repro/kernels/simvote/kernel.py:102"},
        "flash_attention": {
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:70"},
    }

    def note(name, err, kernel_ms, plain_ms, bnd, library_ms=None):
        record[name].update(max_abs_err=float(err), ms=kernel_ms,
                            plain_ms=plain_ms, bound_ms=bnd[0],
                            bound_by=bnd[1], library_ms=library_ms)
        log(f"[kernels] {name}: max_abs_err {err:.3g}, kernel {kernel_ms:.4f}"
            f" ms, plain {plain_ms:.4f} ms, library {library_ms} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})  [{smi}]")

    # ------------------------------------------------------- 2. kernels
    t0 = monotonic()
    ds = make_dataset("imdb_review", n=N_DATA, dim=DIM)
    truth = ds.labels["RV-Q1"]
    log(f"[data] make_dataset n={N_DATA} dim={DIM} in {monotonic() - t0:.1f} s")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(ds.embeddings).to(dev)

    # K1 at the pre-clustering shape: N = 50,000, D = 1024, K = 4, f32.
    # Centroids are means of random rows, as Lloyd's are: a centroid that
    # is itself a row puts d near 0, where the expansion's cancellation
    # (|x|^2 ~ 1e3) swamps any relative tolerance.
    cents = torch.stack([x[torch.from_numpy(rng.choice(N_DATA, 500)).to(dev)]
                         .mean(dim=0) for _ in range(4)])
    a1, d1 = assign_clusters_cuda(x, cents)
    a2, d2 = assign_clusters_ref(x, cents)
    torch.cuda.synchronize()
    agree = (a1 == a2).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f"K1 assignments agree on {agree:.5f} < 0.999")
    torch.testing.assert_close(d1, d2, rtol=1e-5, atol=1e-5)
    n, k = x.shape[0], cents.shape[0]
    note("kmeans_assign", (d1 - d2).abs().max().item(),
         cuda_event_ms(assign_clusters_cuda, x, cents),
         cuda_event_ms(assign_clusters_ref, x, cents),
         bound(4 * (n * DIM + k * DIM + k) + 8 * n,
               2 * n * k * DIM + 2 * n * DIM, "float32"))

    # K3 at a round-0 shape: the four clusters of K1's assignment, 101
    # samples each (min_sample), the rest scored in one launch
    assign = a1.cpu().numpy()
    groups = [np.nonzero(assign == c)[0] for c in range(4)]
    groups = [g for g in groups if len(g) > 101]
    samples = [rng.choice(g, 101, replace=False) for g in groups]
    rests = [np.setdiff1d(g, s) for g, s in zip(groups, samples)]
    counts = np.array([len(r) for r in rests])
    xs = torch.from_numpy(ds.embeddings[np.concatenate(rests)]).to(dev)
    s_pad = torch.from_numpy(np.stack([ds.embeddings[s] for s in samples])).to(dev)
    y_pad = torch.from_numpy(np.stack([truth[s].astype(np.float32)
                                       for s in samples])).to(dev)
    taus = np.array([default_bandwidth(ds.embeddings[s]) for s in samples])
    seg_args = (xs, counts, s_pad, y_pad, taus)
    r1 = simvote_scores_segmented_cuda(*seg_args)
    r2 = simvote_scores_segmented_ref(*seg_args)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=1e-6)
    nr, m = int(counts.sum()), 101
    c = len(counts)
    note("simvote_scores_segmented", (r1 - r2).abs().max().item(),
         cuda_event_ms(simvote_scores_segmented_cuda, *seg_args),
         cuda_event_ms(simvote_scores_segmented_ref, *seg_args),
         bound(4 * (nr * DIM + c * m * DIM + c * m + c + nr),
               2 * nr * m * DIM + 2 * (nr + c * m) * DIM, "float32"))

    # K2 at a sequential-executor shape: one of those clusters alone
    xk2 = xs[:int(counts[0])]
    k2_args = (xk2, s_pad[0], y_pad[0], float(taus[0]))
    r1 = simvote_scores_cuda(*k2_args)
    r2 = simvote_scores_ref(*k2_args)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=1e-6)
    n2 = xk2.shape[0]
    note("simvote_scores", (r1 - r2).abs().max().item(),
         cuda_event_ms(simvote_scores_cuda, *k2_args),
         cuda_event_ms(simvote_scores_ref, *k2_args),
         bound(4 * (n2 * DIM + m * DIM + m + 1 + n2),
               2 * n2 * m * DIM + 2 * (n2 + m) * DIM, "float32"))

    # K4 at one oracle batch of llama3.1-8b: B=64, H=32, KV=8, S=64, hd=128
    B, H, KV, S, hd = 64, 32, 8, 64, 128
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(dtype, S=S):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]

    for dtype, tol, window, s_len in ((torch.float32, 2e-4, None, S),
                                      (torch.bfloat16, 2e-2, None, 32),
                                      (torch.bfloat16, 2e-2, 64, 256),
                                      (torch.float32, 2e-4, 64, 256)):
        q, kk, v = qkv(dtype, s_len)
        torch.testing.assert_close(
            flash_attention_cuda(q, kk, v, window=window).float(),
            flash_attention_ref(q, kk, v, window=window).float(),
            rtol=tol, atol=tol)
        log(f"[kernels] flash_attention {dtype} S={s_len} window={window}: "
            f"within {tol}")
    q, kk, v = qkv(torch.bfloat16)
    o1 = flash_attention_cuda(q, kk, v)
    o2 = flash_attention_ref(q, kk, v)
    torch.testing.assert_close(o1.float(), o2.float(), rtol=2e-2, atol=2e-2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_event_ms(
        lambda: sdpa(q, kk, v, is_causal=True, enable_gqa=True))
    pairs = S * (S + 1) // 2
    note("flash_attention", (o1.float() - o2.float()).abs().max().item(),
         cuda_event_ms(flash_attention_cuda, q, kk, v),
         cuda_event_ms(flash_attention_ref, q, kk, v),
         bound(2 * (2 * B * H * S * hd + 2 * B * KV * S * hd),
               4 * hd * pairs * B * H, "bfloat16"), library_ms)
    del x, xs, s_pad, y_pad, q, kk, v, o1, o2

    by_path = {}

    def counted(path, run, launched):
        """Run one main path with every count at 0; its kernels (and only
        those) must launch.  Returns run()'s result."""
        for fn in counters.values():
            fn.launches = 0
        out = run()
        got = by_path[path] = {k: fn.launches for k, fn in counters.items()}
        log(f"[{path}] launches {got}")
        for name, count in got.items():
            if (count > 0) != (name in launched):
                raise AssertionError(
                    f"{name} launched {count} times on the {path} path, "
                    f"which should launch exactly {sorted(launched)}")
        return out

    # ---------------------------------------------------- 3. data plane
    runs = {}
    for executor, vote_kernel in (("round", "simvote_scores_segmented"),
                                  ("sequential", "simvote_scores")):
        oracle = SyntheticOracle(truth, flip_prob=0.02, seed=0)
        t0 = monotonic()
        res = counted(executor, lambda: semantic_filter(
            ds.embeddings, oracle, CSVConfig(vote="sim", executor=executor)),
            {"kmeans_assign", vote_kernel})
        wall = monotonic() - t0
        acc = float((res.mask == truth).mean())
        log(f"[data] {executor}: {res.n_llm_calls} LLM calls for {N_DATA} "
            f"tuples, {res.recluster_rounds} re-cluster rounds, "
            f"{res.n_voted} voted, {res.n_fallback} fallback, accuracy "
            f"{acc:.4f}, wall {wall:.2f} s  [{smi}]")
        if not res.n_llm_calls < N_DATA:
            raise AssertionError("the filter called the oracle on every tuple")
        if res.n_llm_calls + res.n_voted != N_DATA:
            raise AssertionError("calls + votes do not cover the table")
        if acc < 0.9:
            raise AssertionError(f"accuracy {acc:.4f} against the labels")
        runs[executor] = res
    if not (runs["round"].mask == runs["sequential"].mask).all() or \
            runs["round"].n_llm_calls != runs["sequential"].n_llm_calls:
        raise AssertionError("round and sequential executors disagree")

    # the card against the CPU's plain versions on a small table: one
    # clustering for both and no re-clustering, so the votes (K3 against
    # its plain version) are all that differs, and the runs must be equal
    small = make_dataset("imdb_review", n=4000, dim=DIM, seed=1)
    pre = small.topics % 4
    outs = []
    for device in ("cuda", "cpu"):
        oracle = SyntheticOracle(small.labels["RV-Q1"], flip_prob=0.02, seed=0)
        outs.append(semantic_filter(small.embeddings, oracle,
                                    CSVConfig(vote="sim", max_recluster=0),
                                    precomputed_assign=pre, device=device))
    log(f"[data] n={len(pre)} on the card and on the CPU: {outs[0].n_llm_calls} "
        f"and {outs[1].n_llm_calls} calls, masks equal "
        f"{bool((outs[0].mask == outs[1].mask).all())}")
    if not (outs[0].mask == outs[1].mask).all() or \
            outs[0].n_llm_calls != outs[1].n_llm_calls:
        raise AssertionError("the card and the CPU plain versions disagree")

    # --------------------------------------------------------- 4. model
    cfg = get_config("llama3.1-8b").replace(attn_impl="flash")
    t0 = monotonic()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f} B params in {cfg.dtype}, init "
        f"{monotonic() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f}"
        " GiB on the card")
    mds = make_dataset("imdb_review", n=N_MODEL, dim=DIM)
    tok = HashTokenizer(cfg.vocab_size)
    engine = ServingEngine(cfg, params, max_batch=64)
    oracle = ModelOracle(engine, tok, "the review is positive", mds.texts)
    tracer = Tracer()
    t0 = monotonic()
    with use_tracer(tracer):
        res = counted("model", lambda: semantic_filter(
            mds.embeddings, oracle, CSVConfig(n_clusters=4, vote="sim")),
            {"kmeans_assign", "simvote_scores_segmented", "flash_attention"})
    wall = monotonic() - t0
    launches = by_path["model"]
    engine_s = sum(sp.duration_s for sp in tracer.spans()
                   if sp.kind == "engine_tick")
    st = engine.stats
    log(f"[model] {res.n_llm_calls} LLM calls for {N_MODEL} tuples, "
        f"{res.n_voted} voted, {res.n_fallback} fallback, "
        f"{res.recluster_rounds} re-cluster rounds, wall {wall:.2f} s")
    log(f"[model] engine: {st['batches']} batches, {st['batched_prompts']} "
        f"prompts, {st['prefill_tokens']} prefill tokens in {engine_s:.2f} s "
        f"= {st['prefill_tokens'] / engine_s:.0f} prefill tokens/s, "
        f"bucket fill {engine.batcher.fill_ratio:.3f}  [{smi}]")
    if res.n_llm_calls + res.n_voted != N_MODEL:
        raise AssertionError("calls + votes do not cover the table")
    if launches["flash_attention"] != cfg.n_layers * st["batches"]:
        raise AssertionError(
            f"flash launches {launches['flash_attention']} != "
            f"{cfg.n_layers} x {st['batches']} batches")

    # K4 against its plain version at every (batch, bucket) shape served
    served = sorted({(sp.attrs["batch"], sp.attrs["bucket_len"])
                     for sp in tracer.spans() if sp.kind == "engine_tick"})
    g.manual_seed(1)
    hd, dt = cfg.resolved_head_dim, getattr(torch, cfg.dtype)
    for b, s_len in served:
        q, kk, v = (torch.randn((b, heads, s_len, hd), generator=g,
                                device=dev).to(dt)
                    for heads in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        torch.testing.assert_close(
            flash_attention_cuda(q, kk, v).float(),
            flash_attention_ref(q, kk, v).float(), rtol=2e-2, atol=2e-2)
    log(f"[model] flash_attention within 2e-2 of its plain version at the "
        f"served (batch, bucket) shapes {served}")

    # the served path against the same weights with plain attention
    n_probe = 256
    probe = oracle.pack_prompts(range(n_probe))
    tids = oracle.pack_token_ids(n_probe)
    plain = ServingEngine(cfg.replace(attn_impl="flash-ref"), params,
                          max_batch=64)
    diff = float(np.abs(engine.first_token_logits(probe, tids)
                        - plain.first_token_logits(probe, tids)).max())
    log(f"[model] yes/no logits, flash kernel vs plain attention: max abs "
        f"diff {diff:.4g} over {n_probe} prompts")
    # bf16 rounding through 32 layers: 0.044 over 64 prompts on an H100
    # (PERF.md); the limit is about three times that
    if not diff < 0.15:
        raise AssertionError(f"kernel and plain logits differ by {diff}")

    kernels = []
    for name, rec in record.items():
        split = {path: got[name] for path, got in by_path.items()}
        kernels.append({"name": name, "route": "cuda", **rec,
                        "launches": sum(split.values()),
                        "launches_by_path": split})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
