#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase swallows an exception):

1. build    nvcc builds every kernel from src/repro_torch/csrc into build/.
2. kernels  each CUDA kernel (K1 k-means assignment, K2/K3 SimVote, K4
            flash prefill, K5 flash decoding, K6 Mamba's selective scan)
            against its plain PyTorch version on the card at the main
            path's shapes (K1 also at the model path's n 4,096, at K 33
            and at D 1,023; K3 also at M 300; K6 also at S 1, 17 and 300
            from a given state; K6's bound is the larger of its bytes and
            its exponentials at the SFU's rate), with its time,
            the plain version's time, a library yardstick where one exists
            and the card's least time for the same work (its bound).  The
            times are device time a call, 20 calls between one event pair
            with the host ahead of the card (utils.timing.device_ms); one
            kernel call alone (cuda_event_ms) and the profiler's device
            time a launch (utils.timing.profiler_ms) are logged beside
            them, and whether the host got ahead of the card.  K4
            and K5 take their inputs as the model passes them (strided
            views) and are timed over four rotated input sets, more bytes
            than the 50 MB L2 holds.
3. data     the CSV filter over make_dataset("imdb_review", n=50,000,
            dim=1024) with a SyntheticOracle, round and sequential
            executors, vote="sim"; then a small table on the card and on
            the CPU (plain versions), which must give equal runs.
4. model    the same filter over n=4,096 tuples with a ModelOracle served
            by a random-weight llama3.1-8b at full width and depth (bf16,
            attn_impl="flash") through ServingEngine(max_batch=64); then K4
            against its plain version at every (batch, bucket) shape the
            engine served, and the served logits against plain attention.
5. generate ServingEngine.generate on the same weights and engine: greedy,
            128 prompts of the model path's oracle, 32 new tokens each;
            then K5 against its plain version at every (batch, cache
            length) served, decode_step logits on the kernel path against
            plain attention (one cache, teacher-forced) with a faulty
            control that the limit must catch, the share of tokens on which
            the kernel and plain-attention streams agree, decode tokens/s
            and, from the engine_tick spans less one prefill timed by hand,
            ms per decode step and the prefill share.
6. session  the declarative entry point, Session -> plan -> collect, on the
            phase-3 table: RV-Q1 AND NOT RV-Q2 (SyntheticOracles, flip
            0.02) under ExecutionPolicy(method="csv-sim") with its
            explain(), checked node by node (each node passes at most what
            it took in, takes in what the nodes before it left, and
            decides each live tuple once, memo hits counted by the
            oracle); each leaf alone; the same query in a fresh session
            (equal mask, calls and node_log); a second collect in the first session (0 oracle
            calls, the same mask); shards=4 against shards=1 (equal masks,
            calls and cluster_log).  Then a semantic join of two 400-row
            tables (160,000 pairs, SimVote blocks at D 2 x 1024, accuracy
            >= 0.9) and its repeat under torch.profiler (the same pair
            mask; device busy time and idle share), a Session(engine=...)
            query with a ModelOracle leaf on
            the phase-4 table and engine, and distributed_kmeans_step on a
            one-rank NCCL group against one Lloyd step from K1's
            assignment (1e-5).
7. encode   a full-width e5-large (bf16, random weights from a torch seed)
            embeds the phase-4 table's 4,096 texts at max_len 128 (rows/s
            and tokens/s); a Session whose embedder is that encoder runs
            RV-Q1 under csv-sim over the text-only table; the smoke-width
            encoder on the card against the CPU (f32, ENC_CPU_LIMIT).
8. chunked  gemma3-12b at full width cut to one superblock (5 sliding-
            window layers and 1 global), bf16: lm.forward at S 4,096 under
            attn_impl "auto" (the window layers on the banded schedule),
            "chunked" and "tri", each timed and its logits held against
            "plain" (CHUNK_LIMIT), which a control with halved windows
            must exceed.  The schedules are plain torch: no kernel runs.
9. service  the engine workload of benchmarks/bench_service_throughput.py
            (four filters and a two-leaf cascade, six ModelOracles on the
            phase-4 llama3.1-8b, csv-sim) submitted through Session.submit
            under scheduler.holding(), against serial collect() in a fresh
            session: prompts an engine batch, prefill tokens/s, wall time;
            a decision that differs must sit within DECODE_LIMIT of a tie.
            The same workload on SyntheticOracles must equal serial
            exactly.  A FilterService checkpoint (store_dir in a temporary
            directory) restored in a new session, and a SessionLogStore run
            cut after three of the five queries, replay at 0 oracle calls
            to the same masks.
10. stream  standing queries (repro_torch.stream) on the card.  (a) The
            workload of benchmarks/bench_stream_ingest.py at full data
            size: the phase-3 table arriving 2,500 rows a tick (20 ticks)
            under a RateBudget, RV-Q1 and RV-Q3 on SyntheticOracles,
            csv-sim through the scheduler, a SessionStore checkpoint
            every 5 ticks; each tick's rows, calls, notifications, wall
            ms and K1/K3 launches; as the bench, a fresh re-filter of
            every tick's table (each query's calls logged), whose sum
            the incremental ticks' must undercut by half; the bench's
            delivery contract (no duplicate, no final match left silent;
            vote-flip extras reported against its bound, which the
            reference itself fails under csv-sim: tests/test_torch_stream
            .py::test_sim_stream_vote_flips_match_reference).
            (b) A second watcher stopped after tick 10 through
            shutdown(), a third restored from its store at 0 calls and 0
            launches, whose ticks 11-20 must notify (tick, row) and spend
            calls exactly as (a); its last tick under torch.profiler and
            cProfile (the queries in one thread for that tick), with the
            device's busy ms by kind and the host functions with the most
            own time.  (c) Phase 4's 4,096 rows arriving 512 a tick
            into an empty table, two ModelOracles on the full-width
            engine (csv-sim): calls a tick, engine batches, prompts a
            batch, prefill tokens/s.  (d) repro_torch.launch.watch.main
            in this process, killed after tick 3 and resumed, against an
            unkilled run's notification files.  (e)
            repro_torch.launch.serve.main --service 3 --n 400 --attn-impl
            flash twice (smoke width, as the CLI always is): the second
            replays every predicate at 0 LLM calls.  (d) and (e) must put
            back the signal handlers they install.
11. zoo     the model zoo, after phase 4's llama3.1-8b is released.  (a)
            jamba-v0.1-52b at published widths cut to 2 of its 4
            superblocks (16 of 32 layers: 14 Mamba, 2 attention, 8 MoE
            FFNs of 16 experts), bf16, random weights from a torch seed,
            attn_impl="flash": phase 4's ModelOracle filter over the
            4,096 tuples (csv-sim) through ServingEngine(max_batch=64),
            then generate (128 prompts, 32 new tokens); K4 and K5 against
            their plain versions at every served shape; the yes/no logits
            of 256 prompts against "flash-ref" (ZOO_LIMIT) with the MoE
            routing flips counted and reported; prefill and decode
            tokens/s, a decode step's wall, device busy time and idle
            share (torch.profiler), peak memory.  (b) whisper-base at full
            width and depth, bf16: lm.prefill over 1,500 encoder frames
            (batch 8, a 64-token prompt), 16 decode steps, K4 and K5 at hd
            64 and plain cross-attention, against "flash-ref"
            teacher-forced (DECODE_LIMIT).  (c) internvl2-26b at published
            widths, 2 layers, bf16: lm.forward over 256 prefix embeddings
            and 128 text tokens (K4 at H 48, S 384) against "flash-ref"
            (VLM_LIMIT).
12. train   training on the card, after phase 11 has freed its models.
            (a) qwen1.5-0.5b at published widths and full depth, bf16
            with a float32 master, random weights from a torch seed:
            launch.train's loop, 20 steps of B 4 x S 4,096 from its
            PackedLoader (attn_impl "auto", full remat, loss chunks of
            1,024), a checkpoint at step 10 and at the end, under
            deterministic algorithms; the loss must fall; each save's
            seconds and bytes.  (b) The step-10 checkpoint restored
            through CheckpointManager and steps 10-19 run again: losses
            and final state equal to (a)'s bit for bit.  Then a step's
            wall ms and tokens/s, device busy ms, idle share and top
            kernels (torch.profiler), peak memory, and model FLOPs
            utilisation from the step's FLOPs counted on meta
            (launch.op_cost).  (c) pytest -m cuda over
            tests/test_torch_train_card.py (the smoke train step on the
            card against the CPU, the K4/K5 guards).  (d)
            attn_impl="flash" under gradients must raise.
13. sharded the partitioned program, phase_sharded.  (a) Phase 12's
            model, seed and loader through launch.train's loop for 3
            steps on a ("data", "model") = (1, 1) DeviceMesh over a
            one-rank NCCL group (parameters, optimizer state and batches
            as DTensors): losses, grad norms and state equal to the
            unpartitioned steps bit for bit; ms a step, host enqueue ms and
            idle share each side.  (b) The elastic restore both ways,
            exact, and a step after it.  (c) python -m
            repro_torch.launch.dryrun for qwen1.5-0.5b x train_4k x pod
            and multipod, jamba-v0.1-52b x decode_32k x pod, gemma3-12b x
            train_4k and long_500k x pod, mixtral-8x22b and
            falcon-mamba-7b x decode_32k x pod, mixtral-8x22b x long_500k
            x pod and whisper-base x train_4k x pod, each in a
            process of its own: collectives by kind, the three roofline
            terms, argument and temporary bytes a device; the last two
            (the experts at batch 1, whisper's attention over 16 model
            ranks) beside a CPU host's figures, and each must run at
            most its limit times its share of the step's FLOPs.  (d)
            pytest -m
            cuda over tests/test_torch_sharded_card.py.

Phase 2 also checks K3 at the join's width (round 0 of phase 6's join: 16
blocks, M 101, D 2,048) with its time and bound.

Each kernel wrapper counts its launches.  There are twenty-nine
main-path runs: the round executor, the sequential executor, the model
path, generate, phase 6's session, leaf_RV-Q1 and leaf_RV-Q2 (each leaf
alone), session_repeat, replay, shards, join, model_leaf and
kmeans_step, encode, service and service_replay, phase 10's stream,
stream_tail, stream_engine, watch_cli and serve_cli, phase 11's
zoo_model, zoo_generate, zoo_whisper and zoo_vlm, phase 12's train
and train_resume, and phase 13's sharded_train and sharded_resume.  The
counts are
set to 0 just before each and read just after it, and each run must
launch its own kernels and no other (round:
K1, K3; sequential: K1, K2; model: K1, K3 and K4 = 32 x the engine's
batches; generate: K4 = 32 x batches and K5 = 32 x batches x 32 new
tokens; session, the leaves alone, session_repeat, shards and join: K1,
K3; replay: K3, and K1 where a node it runs again re-clusters;
model_leaf: K1, K3 and K4 = 32 x batches; kmeans_step: K1; encode: K1,
K3; service: K1, K3 and K4 = 32 x the engine's batches; service_replay:
K3, and K1 where a node it runs again re-clusters; stream: K1, K3;
stream_tail: K1, K3 in the tail and none in the restore; stream_engine:
K1, K3 and K4 = 32 x batches; watch_cli: K1 (UniVote); serve_cli: K1
and K4 = the smoke config's layers x batches, none on the replay;
zoo_model: K1, K3, K4 = 2 x batches (jamba's two attention layers) and
K6 = 14 x batches (its Mamba layers' prefill scans); zoo_generate: K4 =
2 x batches, K5 = 2 x decode steps and K6 = 14 x batches; zoo_whisper:
K4 = 6 and K5 = 6 x 16; zoo_vlm: K4 = 2; train, train_resume,
sharded_train and sharded_resume: none, as no kernel has a backward and
K4, K5 and K6 refuse DTensors).
Phase 8 must launch
none.  Checks against plain versions, the join's profiled repeat and
phase 9's serial, synthetic and state-building runs run outside those
windows, as do phase 10's controls and its killed watcher's first ten
ticks.  The service's query threads and its dispatch lane launch on
their current stream, the default stream, where their inputs were made.
In the kernels' JSON record, "launches" is the sum over the runs and
"launches_by_path" splits it.  Before it come the numbers of phases
6-13 ({"session": ...}, {"encode": ...}, {"chunked": ...},
{"service": ...}, {"stream": ...}, {"zoo": ...}, {"train": ...},
{"sharded": ...}); the
second-to-last lines are the kernels' record and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.
"""
import gc
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12      # H100 SXM device memory, bytes/s
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores, bf16 tensor
N_DATA, DIM, N_MODEL = 50_000, 1024, 4096
N_GEN, MAX_NEW = 128, 32   # generate: prompts, new tokens (<= 64: no clamp)
DECODE_LIMIT = 0.25        # teacher-forced decode logits, K5 vs plain
N_JOIN = 400               # session phase: rows of each joined table
ENC_MAX_LEN = 128          # encode phase: tokens a chunk
ENC_CPU_LIMIT = 1e-5       # smoke encoder, card against CPU, f32
CHUNK_S = 4096             # chunked phase: the prompt gemma3-12b prefills
CHUNK_LIMIT = 0.25         # chunked schedules' bf16 logits against plain
SFU_EXP_S = 16 * 132 * 1.98e9  # exponentials a second: 16 a clock an SM


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


def join_tables(make_dataset):
    """The session phase's two joined tables and their pair labels: a pair
    holds when its rows' topics agree mod 2 (tests/test_plan_join.py)."""
    left, right = (make_dataset("imdb_review", n=N_JOIN, dim=DIM, seed=s,
                                n_topics=4) for s in (1, 2))
    truth = (left.topics[:, None] % 2) == (right.topics[None, :] % 2)
    return left, right, truth


def join_round0(el, er, assign_l, assign_r, truth, rng):
    """K3's inputs in round 0 of ``sem_join``: one block per cluster pair,
    each block's 101 sampled pairs as its samples, its other pairs scored
    at the pair width 2 x D."""
    import numpy as np
    from repro_torch.core import theory
    from repro_torch.core.voting import default_bandwidth
    rows, samples, labels = [], [], []
    for cl in range(int(assign_l.max()) + 1):
        for cr in range(int(assign_r.max()) + 1):
            li, rj = np.nonzero(assign_l == cl)[0], np.nonzero(assign_r == cr)[0]
            n = len(li) * len(rj)
            if n == 0:
                continue
            pick = rng.choice(n, theory.choose_sample_size(n, 0.005, 101),
                              replace=False)
            rest = np.setdiff1d(np.arange(n), pick)
            pair = lambda f: np.concatenate(  # noqa: E731
                [el[li[f // len(rj)]], er[rj[f % len(rj)]]], axis=1)
            rows.append(pair(rest))
            samples.append(pair(pick))
            labels.append(truth[li[pick // len(rj)], rj[pick % len(rj)]])
    m = max(len(sm) for sm in samples)
    s_pad = np.zeros((len(samples), m, rows[0].shape[1]), np.float32)
    y_pad = -np.ones((len(samples), m), np.float32)
    for i, (sm, lab) in enumerate(zip(samples, labels)):
        s_pad[i, :len(sm)], y_pad[i, :len(sm)] = sm, lab
    taus = np.array([default_bandwidth(sm) for sm in samples])
    return (np.concatenate(rows), np.array([len(r) for r in rows]), s_pad,
            y_pad, taus)


def check_cascade(res, negated, n, log, tag):
    """The node_log of an And cascade over Pred and Not(Pred) leaves: each
    node passes at most what it took in, takes in the live set the nodes
    before it leave, and decides each live tuple once (sampled, voted or
    fallback; replayed tuples aside).  ``negated[name]`` says whether the
    leaf sits under a Not.  Returns the node sizes for the log."""
    live, sizes = n, []
    for rec in res.node_log:
        fr = rec.result
        if rec.n_out > rec.n_in or rec.n_in != live:
            raise AssertionError(f"[{tag}] node {rec.name}: in {rec.n_in}, "
                                 f"out {rec.n_out}, live set {live}")
        driven = rec.n_in - rec.n_replayed
        asked = sum(rr.n_sampled for rr in fr.round_log) + fr.n_fallback
        voted = sum(rr.n_voted for rr in fr.round_log)
        if fr.n_llm_calls + fr.n_voted > driven or asked + voted != driven \
                or fr.n_voted != voted:
            raise AssertionError(
                f"[{tag}] node {rec.name}: {fr.n_llm_calls} calls + "
                f"{fr.n_voted} voted against {driven} live tuples not "
                f"replayed ({asked} asked, {voted} voted in its rounds)")
        sizes.append((rec.name, rec.n_in, rec.n_out, rec.n_llm_calls,
                      rec.n_replayed, asked - fr.n_llm_calls))
        live = rec.n_in - rec.n_out if negated[rec.name] else rec.n_out
    log(f"[{tag}] node_log (name, in, out, calls, replayed, memo hits "
        f"among the asked): {sizes}")
    return sizes


def phase_session(ds, mds, engine, tok, counted, by_path, log, smi,
                  n_layers):
    """Phase 6: the declarative entry point on the card.  Session -> plan ->
    collect over the 50,000-row table (a cascade, each leaf alone, its
    repeat in a fresh session, its memo replay, four shards), a semantic
    join of two 400-row
    tables with SimVote blocks at D 2 x 1024, a model-backed leaf, and one
    distributed k-means step over a one-rank NCCL group."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import ExecutionPolicy, Session
    from repro_torch.core.clustering import distributed_kmeans_step
    from repro_torch.core.oracle import ModelOracle, SyntheticOracle
    from repro_torch.data import make_dataset
    from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
    from repro_torch.utils.timing import monotonic

    out = {}
    sim = ExecutionPolicy(method="csv-sim")
    truth = ds.labels["RV-Q1"] & ~ds.labels["RV-Q2"]
    negated = {"RV-Q1": False, "RV-Q2": True}

    def oracles():
        return (SyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=0),
                SyntheticOracle(ds.labels["RV-Q2"], flip_prob=0.02, seed=1))

    def cascade(policy, explain=False):
        sess = Session(policy=policy)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        o1, o2 = oracles()
        q = t.filter("RV-Q1", o1) & ~t.filter("RV-Q2", o2)
        t0 = monotonic()
        ex = q.explain() if explain else None
        res = q.collect()
        return q, (o1, o2), res, ex, monotonic() - t0

    def same_run(a, b, what, shards=False):
        keys = lambda r: [(n.name, n.n_in, n.n_out, n.n_llm_calls,  # noqa
                           n.n_replayed) for n in r.node_log]
        if not (a.mask == b.mask).all() or a.n_llm_calls != b.n_llm_calls \
                or keys(a) != keys(b) or (shards and any(
                    a.raw.results[k].cluster_log != b.raw.results[k].cluster_log
                    for k in a.raw.results)):
            raise AssertionError(f"{what}: masks, calls, node_log or "
                                 "cluster_log differ")

    def check_hits(sizes, deltas, tag):
        """A node's tuples asked of its oracle but not paid for are memo
        hits (pilot probes the driver sampled again): the oracle's count."""
        for name, *_, hits in sizes:
            if hits != deltas[name]:
                raise AssertionError(f"[{tag}] node {name}: {hits} asked "
                                     f"without a call, the oracle counted "
                                     f"{deltas[name]} memo hits")

    # ---- the cascade, with its explain
    q, (o1, o2), res, ex, wall = counted("session", lambda: cascade(
        sim, explain=True), {"kmeans_assign", "simvote_scores_segmented"})
    log("[session] explain():\n" + ex.text)
    acc = float((res.mask == truth).mean())
    sizes = check_cascade(res, negated, len(truth), log, "session")
    check_hits(sizes, {"RV-Q1": o1.stats.n_cached,
                       "RV-Q2": o2.stats.n_cached}, "session")
    log(f"[session] RV-Q1 AND NOT RV-Q2 over {len(truth)} tuples: "
        f"{res.n_llm_calls} oracle calls ({res.pilot_calls} pilot), "
        f"n_replayed {res.n_replayed}, order {res.order}, accuracy "
        f"{acc:.4f}, wall {wall:.2f} s (explain + collect)  [{smi}]")
    if acc < 0.9:
        raise AssertionError(f"cascade accuracy {acc:.4f} < 0.9")
    out["cascade"] = dict(calls=res.n_llm_calls, pilot=res.pilot_calls,
                          order=res.order, wall_s=wall, accuracy=acc,
                          nodes=sizes)

    # ---- each leaf alone, in a fresh session, for the cascade's economics
    def single(name):
        sess1 = Session(policy=sim)
        t1 = sess1.table(embeddings=ds.embeddings, name="reviews")
        leaf = t1.filter(name, dict(zip(negated, oracles()))[name])
        t0 = monotonic()
        r = (~leaf if negated[name] else leaf).collect()
        return r, monotonic() - t0

    singles = {}
    for name in negated:
        r, w = counted(f"leaf_{name}", lambda: single(name),
                       {"kmeans_assign", "simvote_scores_segmented"})
        singles[name] = dict(calls=r.n_llm_calls, wall_s=w)
    log(f"[session] the cascade: {res.n_llm_calls} calls, {wall:.2f} s; "
        f"alone, each over all {len(truth)} tuples: "
        + ", ".join(f"{'NOT ' * negated[k]}{k} {v['calls']} calls, "
                    f"{v['wall_s']:.2f} s" for k, v in singles.items())
        + f"  [{smi}]")
    out["cascade"]["alone"] = singles

    # ---- the same query in a fresh session, with fresh oracles
    _, _, again, _, wall2 = counted("session_repeat", lambda: cascade(
        sim), {"kmeans_assign", "simvote_scores_segmented"})
    same_run(again, res, "a fresh session's repeat")
    log(f"[session] repeat in a fresh session: equal mask, "
        f"{again.n_llm_calls} calls and node_log; wall {wall2:.2f} s")
    out["cascade"]["repeat_wall_s"] = wall2

    # ---- its replay: the same query again in the first session.  A node
    # that ran on the whole table replays from the session memo; one that
    # ran on a subset runs its driver again, every oracle answer a memo hit
    # (K3 votes, and K1 re-clusters where it re-clustered before)
    rerun = [n for n in res.node_log if n.n_in < len(truth)]
    before = [o.stats.clone() for o in (o1, o2)]
    t0 = monotonic()
    replay = counted("replay", q.collect, {"simvote_scores_segmented"}
                     | ({"kmeans_assign"} if any(
                         n.result.recluster_rounds for n in rerun)
                        else set()))
    wall_r = monotonic() - t0
    deltas = [o.stats.delta(b) for o, b in zip((o1, o2), before)]
    spent = sum(d.n_calls for d in deltas)
    check_hits(check_cascade(replay, negated, len(truth), log, "replay"),
               {"RV-Q1": deltas[0].n_cached, "RV-Q2": deltas[1].n_cached},
               "replay")
    log(f"[session] replay in the same session: {spent} oracle calls "
        f"spent, n_replayed {replay.n_replayed}, wall {wall_r:.2f} s "
        f"[{smi}]")
    if spent or not (replay.mask == res.mask).all() or not replay.n_replayed:
        raise AssertionError(f"the replay spent {spent} calls, replayed "
                             f"{replay.n_replayed}, or changed the mask")
    out["replay"] = dict(spent=spent, n_replayed=replay.n_replayed,
                         wall_s=wall_r)

    # ---- four shards a round against one, both fresh
    _, _, sharded, _, wall4 = counted("shards", lambda: cascade(
        sim.replace(shards=4)), {"kmeans_assign", "simvote_scores_segmented"})
    same_run(sharded, again, "shards 4 against shards 1", shards=True)
    shard_log = {n: [rr.shards for rr in fr.round_log]
                 for n, fr in sharded.raw.results.items()}
    log(f"[session] shards=4: equal masks, calls and cluster_log to "
        f"shards=1; shards a round {shard_log}; wall {wall4:.2f} s against "
        f"{wall2:.2f} s  [{smi}]")
    if not any(k > 1 for v in shard_log.values() for k in v):
        raise AssertionError("no round of the shards=4 run was split")
    out["shards"] = dict(wall_s=wall4, wall_1_s=wall2, shards=shard_log)

    # ---- a semantic join: SimVote blocks at D 2 x 1024
    left, right, pair_truth = join_tables(make_dataset)
    jsess = Session()
    tl = jsess.table(embeddings=left.embeddings, name="left")
    tr = jsess.table(embeddings=right.embeddings, name="right")
    poracle = SyntheticOracle(pair_truth.ravel(), flip_prob=0.02, seed=3)
    t0 = monotonic()
    jres = counted("join", lambda: tl.join(tr, poracle, policy=sim).collect(),
                   {"kmeans_assign", "simvote_scores_segmented"})
    wall_j = monotonic() - t0
    raw = jres.raw
    n_pairs = pair_truth.size
    asked = sum(rr.n_sampled for rr in raw.round_log) + raw.n_fallback
    jacc = float((jres.pair_mask == pair_truth).mean())
    log(f"[join] {N_JOIN} x {N_JOIN} = {n_pairs} pairs: {raw.n_llm_calls} "
        f"oracle calls, {raw.n_voted} voted, {raw.n_fallback} fallback, "
        f"{raw.refine_rounds} refine rounds (blocks, sampled, voted, "
        f"undetermined a round: {[(r.n_blocks, r.n_sampled, r.n_voted, r.n_undetermined) for r in raw.round_log]}), "
        f"accuracy {jacc:.4f}, wall {wall_j:.2f} s  [{smi}]")
    if asked + raw.n_voted != n_pairs or raw.n_llm_calls > asked:
        raise AssertionError(f"join: {asked} asked + {raw.n_voted} voted do "
                             f"not cover {n_pairs} pairs")
    if jacc < 0.9:
        raise AssertionError(f"join accuracy {jacc:.4f} < 0.9")
    # where the join's wall goes: the same join in a fresh session under
    # torch.profiler; device busy time (kernels and copies) against wall
    from torch.profiler import ProfilerActivity, profile
    psess = Session()
    ptl = psess.table(embeddings=left.embeddings, name="left")
    ptr = psess.table(embeddings=right.embeddings, name="right")
    p_oracle = SyntheticOracle(pair_truth.ravel(), flip_prob=0.02, seed=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = monotonic()
        pres = ptl.join(ptr, p_oracle, policy=sim).collect()
        torch.cuda.synchronize()
        wall_p = monotonic() - t0
    if not (pres.pair_mask == jres.pair_mask).all():
        raise AssertionError("the profiled join's pair mask differs")
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = {}
    for e in dev_events:
        kind = ("K3" if "simvote_kernel" in e.name
                else "K1" if "assign_kernel" in e.name
                else "copies" if "Memcpy" in e.name or "memcpy" in e.name
                else "other")
        busy[kind] = busy.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(busy.values())
    idle = 1 - busy_ms / (wall_p * 1e3)
    log(f"[join] profiled repeat: wall {wall_p:.2f} s, device busy "
        f"{busy_ms:.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in sorted(busy.items()))}), "
        f"idle share {idle:.4f}  [{smi}]")
    out["join"] = dict(calls=raw.n_llm_calls, voted=raw.n_voted,
                       fallback=raw.n_fallback, accuracy=jacc,
                       wall_s=wall_j, rounds=len(raw.round_log),
                       profiled_wall_s=wall_p, busy_ms=busy, idle_share=idle)

    # ---- a model-backed leaf: K4 through the served llama3.1-8b
    msess = Session(engine=engine, policy=sim)
    mt = msess.table(embeddings=mds.embeddings, name="model_reviews")
    synth = SyntheticOracle(mds.labels["RV-Q1"], flip_prob=0.02, seed=0)
    moracle = ModelOracle(engine, tok, "the review is positive", mds.texts)
    batches = engine.stats["batches"]
    t0 = monotonic()
    mres = counted("model_leaf", lambda: (
        mt.filter("RV-Q1", synth)
        & mt.filter("the review is positive", moracle)).collect(),
        {"kmeans_assign", "simvote_scores_segmented", "flash_attention"})
    wall_m = monotonic() - t0
    batches = engine.stats["batches"] - batches
    msizes = check_cascade(mres, {"RV-Q1": False,
                                  "the review is positive": False},
                           len(mds.labels["RV-Q1"]), log, "model_leaf")
    check_hits(msizes, {"RV-Q1": synth.stats.n_cached,
                        "the review is positive": moracle.stats.n_cached},
               "model_leaf")
    k4 = by_path["model_leaf"]["flash_attention"]
    log(f"[model_leaf] {mres.n_llm_calls} oracle calls ({mres.pilot_calls} "
        f"pilot), order {mres.order}, {batches} engine batches, K4 "
        f"launches {k4}, wall {wall_m:.2f} s  [{smi}]")
    if k4 != n_layers * batches:
        raise AssertionError(f"K4 launched {k4} times, not {n_layers} x "
                             f"{batches} batches")
    out["model_leaf"] = dict(calls=mres.n_llm_calls, batches=batches,
                             wall_s=wall_m, nodes=msizes)

    # ---- one distributed k-means step over a one-rank NCCL group
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = os.path.join(ROOT, "build", f"kmeans_step_store_{os.getpid()}")
    x = torch.from_numpy(ds.embeddings).cuda()
    cents = x[:: len(x) // 4][:4].contiguous() + 0.01
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        step = counted("kmeans_step",
                       lambda: distributed_kmeans_step(x, cents),
                       {"kmeans_assign"})
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):  # the store removes its file itself
            os.remove(store)
    a, _ = assign_clusters_cuda(x, cents)
    sums = torch.zeros((4, x.shape[1]), dtype=torch.float64, device=x.device
                       ).index_add_(0, a.long(), x.double())
    counts = torch.bincount(a.long(), minlength=4).double()
    lloyd = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None],
                        cents.double()).float()
    err = (step - lloyd).abs().max().item()
    log(f"[kmeans_step] distributed_kmeans_step on a one-rank NCCL group: "
        f"max abs err {err:.3g} against one Lloyd step in f64 from K1's "
        f"assignment (limit 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"distributed_kmeans_step off by {err}")
    out["kmeans_step_err"] = err
    return out
def phase_encode(mds, counted, log, smi):
    """Phase 7: the paper's phase 1 on the card.  A full-width e5-large
    (bf16, random weights from a torch seed) embeds the phase-4 table's
    texts; a Session whose embedder is that encoder filters the text-only
    table; the smoke-width encoder on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPolicy, Session
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.oracle import SyntheticOracle
    from repro_torch.embeddings import EmbeddingModel
    from repro_torch.embeddings.encoder import init_encoder_params
    from repro_torch.utils.timing import monotonic

    cfg = get_config("e5-large")
    t0 = monotonic()
    model = EmbeddingModel(cfg, seed=0, max_len=ENC_MAX_LEN)
    torch.cuda.synchronize()
    init_s = monotonic() - t0
    texts = list(mds.texts)
    model.encode(texts[:64])                    # warm-up batch
    t0 = monotonic()
    emb = model.encode(texts)                   # numpy: synchronised
    wall = monotonic() - t0
    lens = [len(model.tok.encode(t)) for t in texts]
    chunks = sum(max(1, -(-n // ENC_MAX_LEN)) for n in lens)
    norms = np.linalg.norm(emb, axis=1)
    log(f"[encode] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, {cfg.dtype}, init "
        f"{init_s:.1f} s; {len(texts)} texts ({chunks} chunks of at most "
        f"{ENC_MAX_LEN} tokens, {sum(lens)} tokens) in {wall:.3f} s = "
        f"{len(texts) / wall:.1f} rows/s, {sum(lens) / wall:.0f} tokens/s "
        f"({chunks * ENC_MAX_LEN / wall:.0f} padded positions/s)  [{smi}]")
    if emb.shape != (len(texts), cfg.d_model) or not np.isfinite(emb).all() \
            or not np.allclose(norms, 1.0, atol=1e-4):
        raise AssertionError("the encoder returned malformed embeddings")

    # a text-only table: the session embeds it through the encoder
    sess = Session(embedder=model.encode,
                   policy=ExecutionPolicy(method="csv-sim"))
    table = sess.table(texts=texts, name="texts")
    oracle = SyntheticOracle(mds.labels["RV-Q1"], flip_prob=0.02, seed=0)
    t0 = monotonic()
    res = counted("encode", lambda: table.filter("RV-Q1", oracle).collect(),
                  {"kmeans_assign", "simvote_scores_segmented"})
    wall_q = monotonic() - t0
    fr = res.raw.results["RV-Q1"]
    acc = float((res.mask == mds.labels["RV-Q1"]).mean())
    log(f"[encode] Session(embedder=...) over the text-only table, RV-Q1 "
        f"csv-sim: {res.n_llm_calls} oracle calls, {fr.n_voted} voted, "
        f"{fr.n_fallback} fallback, accuracy {acc:.4f}, wall {wall_q:.2f} s "
        f"(embedding included)  [{smi}]")
    if fr.n_llm_calls + fr.n_voted != len(texts) or acc < 0.9:
        raise AssertionError("the encoder-fed filter did not cover the table "
                             "or fell below accuracy 0.9")
    if not np.array_equal(np.asarray(table.embeddings), emb):
        raise AssertionError("the session's embeddings differ from encode()")

    # the smoke-width encoder: the card against the CPU, float32
    small = smoke_config("e5-large")
    cpu_params = init_encoder_params(small, torch.Generator().manual_seed(0),
                                     device="cpu")
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}  # noqa: E731
                        if isinstance(t, dict) else [to_dev(v) for v in t]
                        if isinstance(t, list) else t.cuda())
    probe = texts[:256]
    want = EmbeddingModel(small, params=cpu_params, max_len=32,
                          device="cpu").encode(probe)
    got = EmbeddingModel(small, params=to_dev(cpu_params),
                         max_len=32).encode(probe)
    err = float(np.abs(got - want).max())
    log(f"[encode] smoke-width encoder, card against CPU (f32, max_len 32, "
        f"{len(probe)} texts): max abs diff {err:.3g} (limit "
        f"{ENC_CPU_LIMIT})")
    if not err < ENC_CPU_LIMIT:
        raise AssertionError(f"the encoder on the card is off by {err}")
    return dict(rows_s=len(texts) / wall, tokens_s=sum(lens) / wall,
                wall_s=wall, chunks=chunks, tokens=sum(lens),
                filter=dict(calls=res.n_llm_calls, voted=fr.n_voted,
                            accuracy=acc, wall_s=wall_q), cpu_err=err)


def phase_chunked(counters, log, smi):
    """Phase 8: gemma3-12b at full width, one superblock (5 sliding-window
    layers and 1 global), bf16, lm.forward at S 4,096 under "auto" (the
    window layers on the banded schedule), "chunked" and "tri", each
    against "plain"; a control with halved windows must exceed the
    limit.  No kernel of the port runs here: the schedules are plain
    torch, as the reference's are XLA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import LayerSpec
    from repro_torch.utils.timing import monotonic

    dev = torch.device("cuda")
    base = get_config("gemma3-12b")
    cfg = base.replace(n_layers=len(base.pattern))
    t0 = monotonic()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    log(f"[chunked] {cfg.name}: {cfg.n_layers} layers "
        f"({[s.window for s in cfg.pattern]}), d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, chunks "
        f"{cfg.attn_chunk_q}/{cfg.attn_chunk_kv}, init "
        f"{monotonic() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab_size, (1, CHUNK_S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    for fn in counters.values():
        fn.launches = 0

    def forward(c):
        """lm.forward under config c: (logits, best ms of two runs)."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = monotonic()
            with torch.inference_mode():
                logits, _ = lm.forward(c, params, tokens)
            torch.cuda.synchronize()
            times.append((monotonic() - t0) * 1e3)
        return logits, min(times)

    want, plain_ms = forward(cfg.replace(attn_impl="plain"))
    out = {"plain_ms": plain_ms}
    for impl in ("auto", "chunked", "tri"):
        got, ms = forward(cfg.replace(attn_impl=impl))
        diff = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            raise AssertionError(f"{impl}: non-finite logits")
        del got
        out[impl] = dict(ms=ms, max_abs_diff=diff)
        log(f"[chunked] attn_impl={impl!r} at S {CHUNK_S}: {ms:.1f} ms "
            f"against plain {plain_ms:.1f} ms ({ms / plain_ms:.2f}x), logits "
            f"max abs diff from plain {diff:.4g} (limit {CHUNK_LIMIT})  "
            f"[{smi}]")
    half = cfg.replace(attn_impl="auto", pattern=tuple(
        LayerSpec(kind=s.kind, window=s.window // 2, ffn=s.ffn)
        if s.window else s for s in cfg.pattern))
    bad, _ = forward(half)
    control = float((bad - want).abs().max())
    del bad, want
    log(f"[chunked] control (windows halved, banded): max abs diff "
        f"{control:.4g}")
    worst = max(out[i]["max_abs_diff"] for i in ("auto", "chunked", "tri"))
    if not worst < CHUNK_LIMIT < control:
        raise AssertionError(
            f"chunked schedules differ from plain by {worst}, the control "
            f"by {control}: the limit {CHUNK_LIMIT} must lie between them")
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if launched:
        raise AssertionError(f"the chunked schedules launched {launched}")
    out["control_diff"] = control
    del params
    torch.cuda.empty_cache()
    return out


SERVICE_PREDICATES = ["the review is positive",
                      "the review praises the acting",
                      "the review discusses the plot",
                      "the review would recommend the movie",
                      "the review complains about pacing",
                      "the review mentions the soundtrack"]
# (labels key, flip seed) for the same workload on SyntheticOracles
SERVICE_SYNTHETIC = [("RV-Q1", 7), ("RV-Q3", 8), ("RV-Q2", 9), ("RV-Q1", 11),
                     ("RV-Q2", 12), ("RV-Q3", 13)]


def service_workload(sess, rows, make_oracle):
    """Four filters and a two-leaf cascade over the table ``rows``, one
    oracle each (benchmarks/bench_service_throughput.py's workload)."""
    t = sess.table(embeddings=rows.embeddings, name="reviews")
    oracles = [make_oracle(i) for i in range(6)]
    names = [f"p{i}" for i in range(6)]
    qs = [t.filter(names[i], oracles[i]) for i in range(4)]
    qs.append(t.filter(names[4], oracles[4]) & t.filter(names[5], oracles[5]))
    return qs, oracles


def phase_service(mds, engine, tok, counted, by_path, log, smi, n_layers):
    """Phase 9: the concurrent service on the card.  Five queries through
    Session.submit under scheduler.holding() on the phase-4 llama3.1-8b
    (K4 in every engine batch), against serial collect() in a fresh
    session; the same with SyntheticOracles, which must equal serial
    exactly; a FilterService checkpoint restored in a new session and a
    SessionLogStore run cut mid-run, both replayed at 0 oracle calls."""
    import tempfile

    import numpy as np
    from repro_torch.api import ExecutionPolicy, Session
    from repro_torch.core.oracle import ModelOracle, SyntheticOracle
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.service import FilterService
    from repro_torch.utils.timing import monotonic

    # the benchmark's engine policy (4 clusters, 8 samples a cluster, 8
    # pilot probes), with SimVote so every round runs K3
    pol = ExecutionPolicy(method="csv-sim", n_clusters=4, min_sample=8,
                          pilot_size=8)
    n = len(mds.labels["RV-Q1"])

    def model_oracle(i):
        return ModelOracle(engine, tok, SERVICE_PREDICATES[i], mds.texts)

    def synth_oracle(i):
        key, seed = SERVICE_SYNTHETIC[i]
        return SyntheticOracle(mds.labels[key], flip_prob=0.02, seed=seed,
                               token_lens=mds.token_lens)

    def engine_mark():
        st = engine.stats
        return st["batches"], st["batched_prompts"], st["prefill_tokens"]

    def submitted(sess, qs):
        with sess.scheduler.holding():
            tickets = [sess.submit(q) for q in qs]
        return sess.gather(*tickets)

    # ---- the model workload, packed through the scheduler
    sess = Session(policy=pol)
    qs, oracles = service_workload(sess, mds, model_oracle)
    tracer = Tracer()
    m0 = engine_mark()
    t0 = monotonic()
    with use_tracer(tracer):
        packed = counted("service", lambda: submitted(sess, qs),
                         {"kmeans_assign", "simvote_scores_segmented",
                          "flash_attention"})
    wall_p = monotonic() - t0
    merge = sess.scheduler.stats.merge
    sess.close()
    m1 = engine_mark()
    ticks = [sp for sp in tracer.spans() if sp.kind == "engine_tick"]
    tick_s = sum(sp.duration_s for sp in ticks)
    batches_p, prompts_p = m1[0] - m0[0], m1[1] - m0[1]
    k4 = by_path["service"]["flash_attention"]
    if k4 != n_layers * batches_p:
        raise AssertionError(f"service: K4 launched {k4} times, not "
                             f"{n_layers} x {batches_p} batches")

    # ---- serial collect() in a fresh session, fresh oracles, same engine
    ssess = Session(policy=pol)
    sqs, soracles = service_workload(ssess, mds, model_oracle)
    t0 = monotonic()
    serial = [q.collect() for q in sqs]
    wall_s = monotonic() - t0
    m2 = engine_mark()
    batches_s, prompts_s = m2[0] - m1[0], m2[1] - m1[1]
    log(f"[service] model workload, 5 queries (6 ModelOracles) over {n} "
        f"rows: packed {sum(r.n_llm_calls for r in packed)} calls in "
        f"{batches_p} engine batches ({prompts_p / batches_p:.2f} prompts a "
        f"batch; {merge.n_invocations} dispatch waves, merge factor "
        f"{merge.merge_factor:.2f}), wall {wall_p:.2f} s; serial "
        f"{sum(r.n_llm_calls for r in serial)} calls in {batches_s} batches "
        f"({prompts_s / batches_s:.2f} prompts a batch), wall {wall_s:.2f} s; "
        f"packing ratio {(prompts_p / batches_p) / (prompts_s / batches_s):.3f}"
        f"x; prefill {m1[2] - m0[2]} tokens in {tick_s:.2f} s of engine_tick "
        f"spans = {(m1[2] - m0[2]) / tick_s:.0f} prefill tokens/s  [{smi}]")

    # decisions of the two runs, oracle by oracle: a decision that differs
    # must sit on a near-tie (its yes/no margin within the decode limit)
    flips = []
    for i, (a, b) in enumerate(zip(oracles, soracles)):
        ma, mb = a.memo_snapshot(), b.memo_snapshot()
        for row in sorted(set(ma) & set(mb)):
            if ma[row] != mb[row]:
                pair = engine.first_token_logits(
                    a.pack_prompts([row]), token_ids=a.pack_token_ids(1))
                flips.append((i, row, float(pair[0, 0] - pair[0, 1])))
    mask_diff = [int((p.mask != s.mask).sum()) for p, s in zip(packed, serial)]
    call_diff = [p.n_llm_calls - s.n_llm_calls for p, s in zip(packed, serial)]
    log(f"[service] packed against serial: {len(flips)} decisions differ "
        f"(oracle, row, yes-no margin): {flips[:20]}; masks differ on "
        f"{mask_diff} rows, calls by {call_diff}")
    big = [f for f in flips if abs(f[2]) > DECODE_LIMIT]
    if big:
        raise AssertionError(f"packed and serial decisions differ beyond "
                             f"near-ties (margin > {DECODE_LIMIT}): {big}")

    # ---- the same workload on SyntheticOracles: packed equals serial
    def synthetic(packed_run):
        s = Session(policy=pol)
        q, o = service_workload(s, mds, synth_oracle)
        res = submitted(s, q) if packed_run else [x.collect() for x in q]
        s.close()
        return res, [x.stats.batch_sizes for x in o]

    sp, sp_batches = synthetic(True)
    ss, ss_batches = synthetic(False)
    same = all((a.mask == b.mask).all() and a.n_llm_calls == b.n_llm_calls
               for a, b in zip(sp, ss)) and sp_batches == ss_batches
    log(f"[service] SyntheticOracle workload: packed and serial masks, calls "
        f"{[r.n_llm_calls for r in sp]} and oracle batch sizes equal: {same}")
    if not same:
        raise AssertionError("the synthetic packed run differs from serial")

    # ---- persistence: a FilterService checkpoint and a cut session log,
    # each replayed in a new session at 0 oracle calls
    with tempfile.TemporaryDirectory() as tmp:
        def build(**kw):
            s = Session(policy=pol)
            qs_, os_ = service_workload(s, mds, synth_oracle)
            for i, o in enumerate(os_):
                s.register_oracle(f"p{i}", o)
            svc = FilterService(s, **kw)
            svc.register_tenant("t0", pol)
            return s, svc, qs_

        def run_all(svc, qs_):
            with svc.session.scheduler.holding():
                tickets = [svc.submit("t0", q) for q in qs_]
            return svc.gather(*tickets)

        s1, svc1, q1 = build(store_dir=f"{tmp}/store")
        first = run_all(svc1, q1)
        svc1.checkpoint()
        svc1.close()
        s2, svc2, q2 = build(store_dir=f"{tmp}/store")
        rep = svc2.restore()

        s3, svc3, q3 = build(log_dir=f"{tmp}/log")
        logged = run_all(svc3, q3[:3])          # the log is cut here
        svc3.log.abandon()
        s3.close()
        s4, svc4, q4 = build(log_dir=f"{tmp}/log")
        lrep = svc4.restore()

        rerun = [nd for r in first for nd in r.node_log
                 if nd.n_in < n and nd.result.recluster_rounds]
        again, log_again = counted(
            "service_replay", lambda: (run_all(svc2, q2),
                                       run_all(svc4, q4[:3])),
            {"simvote_scores_segmented"} | ({"kmeans_assign"} if rerun
                                            else set()))
        spent = s2.stats.n_calls + s4.stats.n_calls
        equal = all((a.mask == b.mask).all() for a, b in
                    zip(first + logged, again + log_again))
        log(f"[service_replay] FilterService checkpoint restored ({rep}); "
            f"session log cut after 3 of 5 queries, restored ({lrep}): "
            f"{spent} oracle calls spent on replay, masks equal {equal}  "
            f"[{smi}]")
        if spent or not equal or any(r.n_llm_calls for r in again + log_again):
            raise AssertionError("the service replays spent oracle calls or "
                                 "changed a mask")
        svc2.close()
        svc4.close()
    return dict(
        packed=dict(calls=[r.n_llm_calls for r in packed], batches=batches_p,
                    prompts=prompts_p, wall_s=wall_p,
                    waves=merge.n_invocations,
                    merge_factor=merge.merge_factor,
                    prefill_tokens_s=(m1[2] - m0[2]) / tick_s),
        serial=dict(calls=[r.n_llm_calls for r in serial], batches=batches_s,
                    prompts=prompts_s, wall_s=wall_s),
        packing_ratio=(prompts_p / batches_p) / (prompts_s / batches_s),
        decision_flips=flips, mask_diff=mask_diff,
        synthetic_calls=[r.n_llm_calls for r in sp], replay_spent=spent)


# phase 10: bench_stream_ingest's workload at full data size
STREAM_TICK = 2500         # (a) rows a tick, 20 ticks over the 50,000 rows
STREAM_QUERIES = [("q0_pos", "RV-Q1", 7), ("q1_act", "RV-Q3", 8)]
STREAM_CONTROL = (5, 10, 15, 20)   # ticks whose own ratio is logged
STREAM_KILL = 10           # (b) the killed watcher's last tick
STREAM_TOP = 12            # (b) host functions logged from the last tick
ENGINE_TICK = 512          # (c) rows of the phase-4 table a tick
WATCH_PREDICATES = ["the review is positive", "the review praises the acting"]


def _tick_log(w, launched, n_ticks=None):
    """Tick ``w`` until its sources drain (or ``n_ticks``): each tick's
    summary with its wall ms and its K1, K3 and K4 launches (``launched``,
    the three wrappers in that order)."""
    from repro_torch.utils.timing import monotonic
    out = []
    while not w.drained and (n_ticks is None or len(out) < n_ticks):
        before = [fn.launches for fn in launched]
        t0 = monotonic()
        s = w.tick()
        s["wall_ms"] = (monotonic() - t0) * 1e3
        s["k1"], s["k3"], s["k4"] = [fn.launches - b
                                     for fn, b in zip(launched, before)]
        out.append(s)
    return out


def check_delivery(sess, events, texts, tag):
    """bench_stream_ingest's delivery contract: no duplicate notification
    and every final match notified (by content key), both required; and
    the notified rows no longer in the final mask (vote flips as clusters
    grow), reported against the bench's bound max(2, 5%).  That bound
    fails on the reference itself under csv-sim: at 4,000 x 256 rows, 400
    a tick, the reference's RV-Q3 mask ends at 16 of 256 true matches
    with 207 flips, and the port gives the same ticks, events and masks
    (tests/test_torch_stream.py::test_sim_stream_vote_flips_match_
    reference).  So it is reported here, not required."""
    from repro_torch.stream import row_key
    out = {}
    for name, evs in events.items():
        rows = [e["row"] for e in evs]
        keys = {e["key"] for e in evs}
        final = [int(i) for i in
                 sess["feed"].filter(name).collect().mask.nonzero()[0]]
        silent = [i for i in final if row_key(texts[i], None) not in keys]
        extra = set(rows) - set(final)
        out[name] = dict(notified=len(rows), final=len(final),
                         silent=len(silent), extra=len(extra),
                         extra_bound=max(2, 0.05 * len(rows)))
        if len(rows) != len(set(rows)) or silent:
            raise AssertionError(f"[{tag}] {name}: delivery contract broken "
                                 f"{out[name]}")
    return out


def phase_stream(ds, mds, engine, tok, counted, by_path, log, smi, n_layers,
                 dev="cuda"):
    """Phase 10 (a)-(c): standing queries on the card.  (a) the stream of
    benchmarks/bench_stream_ingest.py over the 50,000-row table, 2,500
    rows a tick, against a fresh re-filter at four ticks; (b) a second
    watcher killed after tick 10 and a third restored from its store at 0
    calls and 0 launches, whose tail must equal (a)'s; (c) phase 4's 4,096
    rows arriving 512 a tick into an empty table with two ModelOracles on
    the full-width engine."""
    import cProfile
    import pathlib
    import pstats
    import tempfile

    import numpy as np
    import torch
    from repro_torch.api import ExecutionPolicy, Session
    from repro_torch.core.oracle import ModelOracle, SyntheticOracle
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
    from repro_torch.kernels.simvote.kernel import \
        simvote_scores_segmented_cuda
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.service.store import SessionStore
    from repro_torch.stream import (CallbackSink, RateBudget, StreamWatcher,
                                    SyntheticSource)
    from torch.profiler import ProfilerActivity, profile

    kernels = (assign_clusters_cuda, simvote_scores_segmented_cuda,
               flash_attention_cuda)
    pol = ExecutionPolicy(n_clusters=4, xi=0.005, method="csv-sim")
    n = len(ds.texts)
    out = {}

    def watcher(store_dir):
        sess = Session(policy=pol, device=dev)
        for name, key, seed in STREAM_QUERIES:
            sess.register_oracle(name, SyntheticOracle(
                ds.labels[key], flip_prob=0.0, seed=seed,
                token_lens=ds.token_lens))
        w = StreamWatcher(sess, table_name="feed",
                          store=SessionStore(store_dir), checkpoint_every=5)
        w.add_source(SyntheticSource("feed0", texts=list(ds.texts),
                                     embeddings=ds.embeddings,
                                     arrive_per_tick=STREAM_TICK, seed=3),
                     RateBudget(rows_per_tick=STREAM_TICK))
        events = {name: [] for name, _, _ in STREAM_QUERIES}
        for name, evs in events.items():
            w.register(name, sink=CallbackSink(evs.append))
        return sess, w, events

    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the whole stream, ticks logged one by one
        sess, w, events = watcher(f"{tmp}/a")
        ticks = counted("stream", lambda: _tick_log(w, kernels),
                        {"kmeans_assign", "simvote_scores_segmented"})
        for s in ticks:
            log(f"[stream] tick {s['tick']}: +{s['rows']} rows, "
                f"{s['oracle_calls']} calls, {s['notified']} notified, "
                f"{s['wall_ms']:.1f} ms, K1 {s['k1']}, K3 {s['k3']}")
        delivery = check_delivery(sess, events, ds.texts, "stream")
        sess.close()
        if len(ticks) != n // STREAM_TICK or any(s["k4"] for s in ticks):
            raise AssertionError(f"the stream took {len(ticks)} ticks")
        # the bench's control: every tick's table re-filtered in a fresh
        # session, each query's calls kept apart
        control = []
        for t in range(1, len(ticks) + 1):
            c = Session(policy=pol, device=dev)
            h = c.table(texts=list(ds.texts[:t * STREAM_TICK]),
                        embeddings=ds.embeddings[:t * STREAM_TICK],
                        name="feed")
            control.append([h.filter(name, SyntheticOracle(
                ds.labels[key], flip_prob=0.0, seed=seed,
                token_lens=ds.token_lens)).collect().n_llm_calls
                for name, key, seed in STREAM_QUERIES])
            c.close()
        inc = [s["oracle_calls"] for s in ticks]
        ctl = [sum(c) for c in control]
        ratio = sum(inc) / sum(ctl)
        walls = [s["wall_ms"] for s in ticks]
        log(f"[stream] {len(ticks)} ticks of {STREAM_TICK} rows, 2 standing "
            f"queries: {sum(inc)} calls, "
            f"{sum(s['notified'] for s in ticks)} notified, ms a tick mean "
            f"{np.mean(walls):.1f} (first {walls[0]:.1f}, last "
            f"{walls[-1]:.1f}); a fresh re-filter at every tick: {sum(ctl)} "
            f"calls, {[sum(c) for c in zip(*control)]} by query, per tick "
            f"{control}; incremental over re-filter {ratio:.4f}, at ticks "
            f"{STREAM_CONTROL} "
            f"{[round(inc[t - 1] / ctl[t - 1], 4) for t in STREAM_CONTROL]}"
            f"; delivery {delivery}  [{smi}]")
        if not ratio < 0.5:
            raise AssertionError("incremental ticks are not below half the "
                                 "fresh re-filters' calls")
        out["stream"] = dict(ticks=ticks, control=control, delivery=delivery,
                             ratio=ratio)

        # ---- (b) a watcher killed after tick 10, a fresh one restored
        sess_k, w_k, ev_k = watcher(f"{tmp}/b")
        _tick_log(w_k, kernels, STREAM_KILL)
        w_k.shutdown()
        sess_k.close()
        sess_r, w_r, ev_r = watcher(f"{tmp}/b")

        def tail():
            report = w_r.restore()
            rebuilt = [fn.launches for fn in kernels]
            rows = _tick_log(w_r, kernels, n // STREAM_TICK - STREAM_KILL - 1)
            # the last tick under torch.profiler and cProfile: where a
            # tick's time goes.  cProfile sees one thread, so this tick runs
            # the queries in this one; the scheduler runs the same work.
            w_r.use_scheduler = False
            host = cProfile.Profile()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                host.enable()
                rows += _tick_log(w_r, kernels, 1)
                host.disable()
                torch.cuda.synchronize()
            return report, rebuilt, rows, prof, host

        report, rebuilt, tail_ticks, prof, host = counted(
            "stream_tail", tail, {"kmeans_assign", "simvote_scores_segmented"})
        calls_rebuild = sess_r.stats.n_calls - sum(
            s["oracle_calls"] for s in tail_ticks)
        sess_r.close()
        busy = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kind = ("K3" if "simvote_kernel" in e.name
                    else "K1" if "assign_kernel" in e.name
                    else "HtoD" if "HtoD" in e.name
                    else "DtoH" if "DtoH" in e.name else "other")
            busy[kind] = busy.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3
        last_ms = tail_ticks[-1]["wall_ms"]
        same = all([(e["tick"], e["row"]) for e in ev_r[q]]
                   == [(e["tick"], e["row"]) for e in events[q]
                       if e["tick"] > STREAM_KILL] for q in events)
        same_calls = [s["oracle_calls"] for s in tail_ticks] == \
            [s["oracle_calls"] for s in ticks[STREAM_KILL:]]
        log(f"[stream_tail] restored at tick {w_r.stats.n_ticks - len(tail_ticks)}"
            f" ({report}): {calls_rebuild} oracle calls and launches "
            f"{rebuilt} to rebuild; ticks {STREAM_KILL + 1}-"
            f"{tail_ticks[-1]['tick']}: notified as the unkilled run {same}, "
            f"calls a tick as the unkilled run {same_calls}; the last tick "
            f"under torch.profiler: wall {last_ms:.1f} ms, device busy "
            f"{sum(busy.values()):.2f} ms "
            f"({', '.join(f'{k} {v:.2f}' for k, v in sorted(busy.items()))})"
            f", idle share {1 - sum(busy.values()) / last_ms:.4f}  [{smi}]")
        own = sorted(((v[2], f"{pathlib.Path(k[0]).name}:{k[1]}({k[2]})")
                      for k, v in pstats.Stats(host).stats.items()),
                     reverse=True)[:STREAM_TOP]
        log(f"[stream_tail] the last tick's host functions by own time "
            f"(cProfile on, queries in one thread): "
            + ", ".join(f"{name} {t * 1e3:.1f} ms" for t, name in own)
            + f"  [{smi}]")
        if calls_rebuild or any(rebuilt) or not same or not same_calls:
            raise AssertionError("the restored watcher spent calls or "
                                 "launches to rebuild, or its tail differs")
        out["stream_tail"] = dict(rebuild_calls=calls_rebuild,
                                  rebuild_launches=rebuilt,
                                  ticks=[s["wall_ms"] for s in tail_ticks],
                                  last_tick_busy_ms=busy,
                                  last_tick_ms=last_ms,
                                  last_tick_host_ms={name: t * 1e3
                                                     for t, name in own})

    # ---- (c) the engine: an empty table, phase 4's rows 512 a tick
    esess = Session(policy=ExecutionPolicy(n_clusters=4, min_sample=25,
                                           method="csv-sim"), device=dev)
    handle = esess.table(texts=[], embeddings=np.zeros(
        (0, mds.embeddings.shape[1]), np.float32), name="feed")
    for i, pred in enumerate(WATCH_PREDICATES):
        # the table copies the texts it is given: the oracles read its list
        esess.register_oracle(f"p{i}", ModelOracle(engine, tok, pred,
                                                   handle._table.texts))
    ew = StreamWatcher(esess, table_name="feed")
    ew.add_source(SyntheticSource("feed0", texts=list(mds.texts),
                                  embeddings=mds.embeddings,
                                  arrive_per_tick=ENGINE_TICK, seed=11),
                  RateBudget(rows_per_tick=ENGINE_TICK))
    e_events = {f"p{i}": [] for i in range(len(WATCH_PREDICATES))}
    for name, evs in e_events.items():
        ew.register(name, sink=CallbackSink(evs.append))
    tracer = Tracer()
    st0 = dict(engine.stats)

    def engine_ticks():
        with use_tracer(tracer):
            rows = []
            while not ew.drained:
                b0 = engine.stats["batches"]
                rows += _tick_log(ew, kernels, 1)
                rows[-1]["batches"] = engine.stats["batches"] - b0
            return rows

    eticks = counted("stream_engine", engine_ticks,
                     {"kmeans_assign", "simvote_scores_segmented",
                      "flash_attention"})
    esess.close()
    batches = engine.stats["batches"] - st0["batches"]
    prompts = engine.stats["batched_prompts"] - st0["batched_prompts"]
    tokens = engine.stats["prefill_tokens"] - st0["prefill_tokens"]
    tick_s = sum(sp.duration_s for sp in tracer.spans()
                 if sp.kind == "engine_tick")
    k4 = by_path["stream_engine"]["flash_attention"]
    for s in eticks:
        log(f"[stream_engine] tick {s['tick']}: +{s['rows']} rows, "
            f"{s['oracle_calls']} calls in {s['batches']} engine batches, "
            f"{s['notified']} notified, {s['wall_ms']:.1f} ms, K1 {s['k1']}, "
            f"K3 {s['k3']}, K4 {s['k4']}")
    log(f"[stream_engine] {len(eticks)} ticks of {ENGINE_TICK} rows, 2 "
        f"ModelOracles on {engine.cfg.name} ({n_layers} layers, "
        f"{engine.cfg.dtype}, {engine.cfg.attn_impl}): {sum(s['oracle_calls'] for s in eticks)} calls, {batches} "
        f"engine batches, {prompts / max(1, batches):.2f} prompts a batch, "
        f"{tokens} prefill tokens in {tick_s:.2f} s of engine_tick spans = "
        f"{tokens / tick_s:.0f} prefill tokens/s, K4 {k4}  [{smi}]")
    if k4 != n_layers * batches or len(eticks) != len(mds.texts) // ENGINE_TICK:
        raise AssertionError(f"stream_engine: K4 launched {k4} times, not "
                             f"{n_layers} x {batches} batches")
    out["stream_engine"] = dict(
        ticks=eticks, batches=batches, prompts_a_batch=prompts / batches,
        prefill_tokens_s=tokens / tick_s, k4=k4)
    return out


def phase_cli(counted, by_path, log, smi):
    """Phase 10 (d)-(e): the launchers in this process.  ``watch`` killed
    after tick 3 and resumed, whose notification files must equal an
    unkilled run's; ``serve --service 3`` twice, the second replaying
    every predicate at 0 LLM calls.  Each must put the signal handlers it
    installs back."""
    import contextlib
    import io
    import pathlib
    import signal
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch import serve, watch

    handlers = lambda: [signal.getsignal(s)  # noqa: E731
                        for s in (signal.SIGINT, signal.SIGTERM)]
    before = handlers()

    def cli(tag, main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = main(argv)
        for line in buf.getvalue().splitlines():
            log(f"[{tag}]   {line}")
        if handlers() != before:
            raise AssertionError(f"{tag} left its signal handlers installed")
        return buf.getvalue(), ret

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--n", "240", "--queries", "2"]
        killed = ["--state-dir", f"{tmp}/w"]

        def watch_runs():
            first = cli("watch_cli", watch.main,
                        common + killed + ["--kill-after", "3"])[0]
            second = cli("watch_cli", watch.main, common + killed)[0]
            cli("watch_cli", watch.main, common + ["--state-dir",
                                                   f"{tmp}/fresh"])
            return first, second

        first, second = counted("watch_cli", watch_runs, {"kmeans_assign"})
        files = {d: [pathlib.Path(f"{tmp}/{d}/notify_p{i}.jsonl").read_text()
                     for i in range(2)] for d in ("w", "fresh")}
        ok = ("0 oracle calls to rebuild" in second
              and "resumed done" in second and "stopping mid-stream" in first
              and files["w"] == files["fresh"])
        log(f"[watch_cli] killed after tick 3 and resumed: rebuild and resume "
            f"lines printed, notify files equal to an unkilled run's: {ok}")
        if not ok:
            raise AssertionError("watch_cli: resume lines or notify files")
        out["watch_cli"] = dict(notified=[f.count("\n") for f in files["w"]])

        argv = ["--service", "3", "--n", "400", "--attn-impl", "flash",
                "--state-dir", f"{tmp}/s"]

        def serve_runs():
            text1, (engine, _, res1) = cli("serve_cli", serve.main, argv)
            k4 = flash_attention_cuda.launches
            text2, (_, _, res2) = cli("serve_cli", serve.main, argv)
            return (text1, engine, res1, k4, text2, res2,
                    flash_attention_cuda.launches - k4)

        text1, engine, res1, k4, text2, res2, k4_replay = counted(
            "serve_cli", serve_runs, {"kmeans_assign", "flash_attention"})
        layers = smoke_config("llama3.1-8b").n_layers
        passes = [int(r.mask.sum()) for r in res1]
        replayed = all(f"{p}/400 pass; 0 LLM calls, 400 replayed" in text2
                       for p in passes) and \
            [int(r.mask.sum()) for r in res2] == passes
        log(f"[serve_cli] smoke llama3.1-8b ({layers} layers, flash): "
            f"{[r.n_llm_calls for r in res1]} LLM calls, passes {passes}, "
            f"{engine.stats['batches']} engine batches, K4 {k4}; rerun "
            f"replays every predicate at 0 LLM calls: {replayed}, K4 "
            f"{k4_replay}")
        if k4 != layers * engine.stats["batches"] or k4_replay or not replayed:
            raise AssertionError("serve_cli: K4 against batches, or the "
                                 "replay")
        out["serve_cli"] = dict(calls=[r.n_llm_calls for r in res1],
                                passes=passes,
                                batches=engine.stats["batches"], k4=k4)
    return out


# phase 11: the model zoo on the card
ZOO_SUPERBLOCKS = 2        # (a) jamba superblocks of 8 layers: 16 of 32
# (a) yes/no logits, kernels against plain: bf16 rounding through 16
# layers moves 2.2% of the MoE routing choices, and the logits by 0.72 at
# most over 256 prompts on an H100 (PERF.md); the limit is about three
# times that
ZOO_LIMIT = 2.0
WHISPER_B, WHISPER_S, WHISPER_STEPS = 8, 64, 16   # (b) batch, prompt, steps
VLM_B, VLM_TEXT = 4, 128   # (c) batch, text tokens after the 256 prefix
VLM_LIMIT = 0.2            # (c) logits, kernels against plain: 0.063 on
                           # an H100 (PERF.md), about three times that
PROFILE_STEPS = 4          # (a) decode steps under torch.profiler


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def _released(log, phase: int = 11, tag: str = "zoo"):
    """Device memory the earlier phases left allocated (GiB), and the live
    threads.  Fails above 4 GiB (phase 4's llama3.1-8b alone is 15 GiB),
    naming the largest tensors still alive and what holds each."""
    import threading

    import torch
    left = torch.cuda.memory_allocated() / 2**30
    names = sorted(t.name for t in threading.enumerate())
    log(f"[{tag}] before phase {phase}: {left:.2f} GiB still allocated, "
        f"{len(names)} threads {names}")
    if left > 4.0:
        big = sorted((o for o in gc.get_objects()
                      if isinstance(o, torch.Tensor) and o.is_cuda),
                     key=lambda t: -t.numel() * t.element_size())[:3]
        held = [(tuple(t.shape), sorted({type(r).__name__
                                         for r in gc.get_referrers(t)}))
                for t in big]
        raise AssertionError(f"{left:.1f} GiB not released before phase "
                             f"{phase}; largest tensors and their holders: "
                             f"{held}")
    return left


def _busy_ms(fn, calls: int):
    """Device busy ms a call of fn (the sum of its kernels' times under
    torch.profiler, over ``calls`` calls) and its launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls,
            len(kernels) / calls)


def phase_zoo(mds, counted, by_path, log, smi, dev="cuda"):
    """Phase 11: the model zoo on the card.  (a) jamba-v0.1-52b at
    published widths cut to 2 of its 4 superblocks (16 of 32 layers:
    Mamba, MoE and attention), bf16, random weights, attn_impl="flash":
    phase 4's ModelOracle filter over the 4,096 tuples (K1, K3, K4 = 2 x
    batches), generate (128 prompts, 32 new tokens; K4 = 2 x batches, K5 =
    2 x decode steps), K4 and K5 against their plain versions at every
    served shape, the yes/no logits of 256 prompts against "flash-ref"
    with the MoE routing flips counted, a decode step's wall and idle
    share, peak memory.  (b) whisper-base at full width and depth, bf16:
    lm.prefill over 1,500 encoder frames, 16 decode steps (K4 and K5 at hd
    64, cross-attention plain) against "flash-ref" teacher-forced.  (c)
    internvl2-26b at published widths, 2 layers, bf16: lm.forward over
    256 prefix embeddings and 128 text tokens (K4 at H 48, S 384) against
    "flash-ref"."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.csv_filter import CSVConfig, semantic_filter
    from repro_torch.core.oracle import ModelOracle
    from repro_torch.data import HashTokenizer
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers, lm
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.batcher import BucketBatcher
    from repro_torch.utils.timing import monotonic

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    out = {}

    def check_k4(shapes, tag):
        """K4 against its plain version at bf16 (batch, H, KV, S, hd)
        shapes, on the strided views the model passes."""
        for b, H, KV, S, hd in shapes:
            q, k, v = (torch.randn((b, S, n, hd), generator=g, device=dev)
                       .to(torch.bfloat16).transpose(1, 2)
                       for n in (H, KV, KV))
            torch.testing.assert_close(
                flash_attention_cuda(q, k, v).float(),
                flash_attention_ref(q, k, v).float(), rtol=2e-2, atol=2e-2)
        log(f"[zoo] {tag}: flash_attention within 2e-2 of its plain version "
            f"at (batch, H, KV, S, hd) {shapes}")

    def check_k5(shapes, tag):
        """K5 against its plain version at bf16 (batch, H, KV, L, hd)
        shapes: the model's (b, L, KV, hd) cache permuted, ragged
        lengths."""
        for b, H, KV, L, hd in shapes:
            qd = torch.randn((b, H, hd), generator=g,
                             device=dev).to(torch.bfloat16)
            kd, vd = (torch.randn((b, L, KV, hd), generator=g, device=dev)
                      .to(torch.bfloat16).permute(0, 2, 1, 3)
                      for _ in range(2))
            lens = torch.randint(1, L + 1, (b,), generator=g, device=dev)
            lens[0], lens[-1] = 1, L
            lens = lens.to(torch.int32)
            torch.testing.assert_close(
                decode_attention_cuda(qd, kd, vd, lens).float(),
                decode_attention_ref(qd, kd, vd, lens).float(),
                rtol=2e-2, atol=2e-2)
        log(f"[zoo] {tag}: decode_attention within 2e-2 of its plain version "
            f"at (batch, H, KV, L, hd) {shapes}")

    # ------------------------------------------------ (a) jamba-v0.1-52b
    base = get_config("jamba-v0.1-52b")
    cfg = base.replace(n_layers=ZOO_SUPERBLOCKS * len(base.pattern),
                       attn_impl="flash")
    left = _released(log)
    torch.cuda.reset_peak_memory_stats()
    t0 = monotonic()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    n_attn = cfg.n_superblocks * sum(s.kind == "attn" for s in cfg.pattern)
    n_moe = cfg.n_superblocks * sum(s.ffn == "moe" for s in cfg.pattern)
    n_mamba = cfg.n_layers - n_attn
    weights_gib = torch.cuda.memory_allocated() / 2**30 - left
    log(f"[zoo] {cfg.name}: {cfg.n_layers} of {base.n_layers} layers "
        f"({n_attn} attention, {cfg.n_layers - n_attn} Mamba, {n_moe} MoE of "
        f"{cfg.n_experts} experts top-{cfg.top_k}), d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, {cfg.param_count() / 1e9:.2f} B params in "
        f"{cfg.dtype}, init {monotonic() - t0:.1f} s, {weights_gib:.1f} GiB "
        f"on the card")
    tok = HashTokenizer(cfg.vocab_size)
    engine = ServingEngine(cfg, params, max_batch=64, device=dev)
    oracle = ModelOracle(engine, tok, "the review is positive", mds.texts)
    tracer = Tracer()
    t0 = monotonic()
    with use_tracer(tracer):
        res = counted("zoo_model", lambda: semantic_filter(
            mds.embeddings, oracle, CSVConfig(n_clusters=4, vote="sim"),
            device=dev),
            {"kmeans_assign", "simvote_scores_segmented", "flash_attention",
             "selective_scan"})
    wall = monotonic() - t0
    engine_s = sum(sp.duration_s for sp in tracer.spans()
                   if sp.kind == "engine_tick")
    st = dict(engine.stats)
    served = sorted({(sp.attrs["batch"], sp.attrs["bucket_len"])
                     for sp in tracer.spans() if sp.kind == "engine_tick"})
    prefill_tps = st["prefill_tokens"] / engine_s
    padded_tps = sum(sp.attrs["batch"] * sp.attrs["bucket_len"]
                     for sp in tracer.spans()
                     if sp.kind == "engine_tick") / engine_s
    log(f"[zoo] filter: {res.n_llm_calls} LLM calls for {len(mds.texts)} "
        f"tuples, {res.n_voted} voted, wall {wall:.2f} s; engine "
        f"{st['batches']} batches at (batch, bucket) {served}, "
        f"{st['prefill_tokens']} prefill tokens in {engine_s:.2f} s = "
        f"{prefill_tps:.0f} prefill tokens/s ({padded_tps:.0f} padded)  "
        f"[{smi}]")
    if res.n_llm_calls + res.n_voted != len(mds.texts):
        raise AssertionError("calls + votes do not cover the table")
    for name, n in (("flash_attention", n_attn), ("selective_scan", n_mamba)):
        if by_path["zoo_model"][name] != n * st["batches"]:
            raise AssertionError(
                f"{name} launches {by_path['zoo_model'][name]} != {n} x "
                f"{st['batches']} batches")
    routes = [tracer.metrics.snapshot().get(f"mamba.scan_{r}", 0)
              for r in ("kernel", "plain")]
    log(f"[zoo] Mamba scan routes: kernel {routes[0]}, plain {routes[1]} "
        f"({n_mamba} Mamba layers x {st['batches']} batches)")
    if routes != [n_mamba * st["batches"], 0]:
        raise AssertionError(f"Mamba scan routes {routes}")
    check_k4([(b, cfg.n_heads, cfg.n_kv_heads, s, cfg.resolved_head_dim)
              for b, s in served], "jamba prefill")

    gen_prompts = oracle.pack_prompts(range(N_GEN))
    tracer = Tracer()
    decoded = engine.stats["decode_tokens"]
    with use_tracer(tracer):
        streams = counted("zoo_generate", lambda: engine.generate(
            gen_prompts, max_new=MAX_NEW),
            {"flash_attention", "decode_attention", "selective_scan"})
    ticks = [sp for sp in tracer.spans()
             if sp.kind == "engine_tick" and sp.attrs["phase"] == "generate"]
    gen_s = sum(sp.duration_s for sp in ticks)
    decoded = engine.stats["decode_tokens"] - decoded
    gen_served = sorted({(sp.attrs["batch"], sp.attrs["bucket_len"])
                         for sp in ticks})
    launches = by_path["zoo_generate"]
    log(f"[zoo] generate: {N_GEN} prompts, {MAX_NEW} new tokens each, "
        f"{len(ticks)} batches at (batch, bucket) {gen_served}: {decoded} "
        f"decode tokens in {gen_s:.3f} s of engine_tick spans = "
        f"{decoded / gen_s:.1f} decode tokens/s  [{smi}]")
    if [len(s) for s in streams] != [MAX_NEW] * N_GEN or \
            not all(0 <= t < cfg.padded_vocab for s in streams for t in s):
        raise AssertionError("generate returned malformed streams")
    if launches["flash_attention"] != n_attn * len(ticks) or \
            launches["decode_attention"] != n_attn * len(ticks) * MAX_NEW \
            or launches["selective_scan"] != n_mamba * len(ticks):
        raise AssertionError(
            f"generate launched K4 {launches['flash_attention']}, K5 "
            f"{launches['decode_attention']} and K6 "
            f"{launches['selective_scan']} times over {len(ticks)} batches")
    check_k5([(b, cfg.n_heads, cfg.n_kv_heads, s + 64, cfg.resolved_head_dim)
              for b, s in gen_served], "jamba decode")

    # a decode step: wall (synchronised) and the device's busy share under
    # torch.profiler, from one batch's prefill cache
    idx, toks, lens = BucketBatcher(max_batch=64).plan(gen_prompts)[0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = monotonic()
        h, cache, _ = lm.prefill_hidden(cfg, params,
                                        torch.from_numpy(toks).to(dev),
                                        max_len=toks.shape[1] + 64)
        pos = torch.from_numpy(lens).to(dev)
        cur = torch.argmax(lm.hidden_logits(
            cfg, params, h[torch.arange(len(idx), device=dev), pos - 1]),
            dim=-1)
        torch.cuda.synchronize()
        prefill_ms = (monotonic() - t0) * 1e3
        del h

        def step():
            nonlocal cache, pos, cur
            logits, cache = lm.decode_step(cfg, params, cache, cur, pos)
            pos, cur = pos + 1, torch.argmax(logits, dim=-1)

        step()
        walls = []  # three rounds: host time varies between rounds
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = monotonic()
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
            walls.append((monotonic() - t0) * 1e3 / PROFILE_STEPS)
        step_ms = sorted(walls)[1]
        busy_ms, step_launches = _busy_ms(step, PROFILE_STEPS)
        del cache
    step_bound_ms = sum(t.numel() * t.element_size()
                        for sb in params["blocks"] for layer in sb.values()
                        for d in layer.values()
                        for t in d.values()) / HBM_BYTES_S * 1e3
    log(f"[zoo] a decode step at batch {len(idx)} (cache {toks.shape[1] + 64}"
        f"): wall {step_ms:.2f} ms (median of "
        f"{[round(w, 2) for w in walls]}), kernels busy {busy_ms:.2f} ms, idle "
        f"share {1 - busy_ms / step_ms:.4f}, {step_launches:.0f} launches;"
        f" its layer weights' byte bound {step_bound_ms:.2f} ms; "
        f"the batch's prefill {prefill_ms:.1f} ms  [{smi}]")

    # the yes/no logits against the same weights under plain attention,
    # each MoE layer's expert choice recorded in both runs
    n_probe = 256
    probe = oracle.pack_prompts(range(n_probe))
    tids = oracle.pack_token_ids(n_probe)
    plain = ServingEngine(cfg.replace(attn_impl="flash-ref"), params,
                          max_batch=64, device=dev)
    real_route = layers.moe_route
    routes = {}

    def run(eng, key):
        routes[key] = []

        def spy(c, p, x):
            r = real_route(c, p, x)
            routes[key].append(r[2])
            return r

        layers.moe_route = spy
        try:
            return eng.first_token_logits(probe, tids)
        finally:
            layers.moe_route = real_route

    got, want = run(engine, "flash"), run(plain, "plain")
    diff = float(np.abs(got - want).max())
    plan = BucketBatcher(max_batch=64).plan(probe)
    flips = real = 0
    flipped = np.zeros(n_probe, bool)  # prompts with any routing flip
    for i, (a, b) in enumerate(zip(routes["flash"], routes["plain"])):
        rows, _, lens_b = plan[i // n_moe]
        lens_b = torch.from_numpy(lens_b).to(dev)
        mask = torch.arange(a.shape[1], device=dev)[None, :] < lens_b[:, None]
        flip = (a != b).any(-1) & mask
        flips += int(flip.sum())
        real += int(mask.sum())
        flipped[rows] |= flip.any(-1).cpu().numpy()
    unflipped = ~flipped
    diff_unflipped = (float(np.abs(got - want)[unflipped].max())
                      if unflipped.any() else None)
    decisions = int((oracle.pack_labels(got) != oracle.pack_labels(want))
                    .sum())
    log(f"[zoo] yes/no logits, kernels vs plain attention: max abs diff "
        f"{diff:.4g} over {n_probe} prompts (limit {ZOO_LIMIT}); routing "
        f"flips {flips} of {real} real (token, MoE layer) choices, in "
        f"{int(flipped.sum())} prompts; over the {int(unflipped.sum())} "
        f"prompts without a flip the max abs diff is {diff_unflipped}; "
        f"decisions differing {decisions}")
    if not diff < ZOO_LIMIT:
        raise AssertionError(f"kernel and plain logits differ by {diff}")
    out["jamba"] = dict(
        layers=cfg.n_layers, params_b=cfg.param_count() / 1e9,
        weights_gib=weights_gib, calls=res.n_llm_calls,
        batches=st["batches"], prefill_tokens_s=prefill_tps,
        padded_tokens_s=padded_tps, filter_wall_s=wall,
        decode_tokens_s=decoded / gen_s, step_ms=step_ms,
        step_busy_ms=busy_ms, step_idle_share=1 - busy_ms / step_ms,
        step_bound_ms=step_bound_ms, prefill_ms=prefill_ms,
        logits_diff=diff, logits_diff_unflipped=diff_unflipped,
        routing_flips=flips, routed=real,
        prompts_flipped=int(flipped.sum()),
        decisions_differing=decisions, peak_gib=_peak_gib())
    log(f"[zoo] jamba peak memory {_peak_gib():.1f} GiB  [{smi}]")
    del params, engine, plain, oracle, got, want, routes
    torch.cuda.empty_cache()

    # ------------------------------------------------ (b) whisper-base
    wcfg = get_config("whisper-base").replace(attn_impl="flash")
    wparams = lm.init_params(wcfg, torch.Generator(device=dev).manual_seed(1),
                             device=dev)
    frames = torch.randn((WHISPER_B, wcfg.encoder_len, wcfg.d_model),
                         generator=g, device=dev).to(torch.bfloat16)
    prompt = torch.randint(8, wcfg.vocab_size, (WHISPER_B, WHISPER_S),
                           generator=g, device=dev)
    max_len = WHISPER_S + WHISPER_STEPS

    def decode(c, fed=None):
        """prefill, then WHISPER_STEPS decode steps: greedy, or fed the
        tokens ``fed`` (teacher-forced).  Returns the logits of each step
        (the prefill's last position first), the tokens fed, and ms."""
        torch.cuda.synchronize()
        t0 = monotonic()
        logits, cache, pos = lm.prefill(c, wparams, prompt, enc_frames=frames,
                                        max_len=max_len, last_only=True)
        torch.cuda.synchronize()
        t1 = monotonic()
        seen, toks = [logits], []
        for i in range(WHISPER_STEPS):
            cur = torch.argmax(logits, -1) if fed is None else fed[i]
            toks.append(cur)
            logits, cache = lm.decode_step(c, wparams, cache, cur, pos)
            pos = pos + 1
            seen.append(logits)
        torch.cuda.synchronize()
        return seen, toks, ((t1 - t0) * 1e3,
                            (monotonic() - t1) * 1e3 / WHISPER_STEPS)

    with torch.inference_mode():
        seen, fed, (w_prefill_ms, w_step_ms) = counted(
            "zoo_whisper", lambda: decode(wcfg),
            {"flash_attention", "decode_attention"})
        ref, _, _ = decode(wcfg.replace(attn_impl="flash-ref"), fed)
    launches = by_path["zoo_whisper"]
    if launches["flash_attention"] != wcfg.n_layers or \
            launches["decode_attention"] != wcfg.n_layers * WHISPER_STEPS:
        raise AssertionError(f"whisper launched {launches}")
    w_diff = max(float((a - b).abs().max()) for a, b in zip(seen, ref))
    if not all(torch.isfinite(a).all() for a in seen):
        raise AssertionError("whisper: non-finite logits")
    log(f"[zoo] {wcfg.name}: {wcfg.n_layers}+{wcfg.encoder_layers} layers, "
        f"batch {WHISPER_B}, {wcfg.encoder_len} frames, prompt {WHISPER_S}, "
        f"{WHISPER_STEPS} steps: prefill (encoder included) "
        f"{w_prefill_ms:.1f} ms, {w_step_ms:.2f} ms a decode step; logits "
        f"against plain attention, teacher-forced: max abs diff "
        f"{w_diff:.4g} (limit {DECODE_LIMIT})  [{smi}]")
    if not w_diff < DECODE_LIMIT:
        raise AssertionError(f"whisper kernel and plain logits differ by "
                             f"{w_diff}")
    hd = wcfg.resolved_head_dim
    check_k4([(WHISPER_B, wcfg.n_heads, wcfg.n_kv_heads, WHISPER_S, hd)],
             "whisper prefill")
    check_k5([(WHISPER_B, wcfg.n_heads, wcfg.n_kv_heads, max_len, hd)],
             "whisper decode")
    out["whisper"] = dict(prefill_ms=w_prefill_ms, step_ms=w_step_ms,
                          logits_diff=w_diff)
    del wparams, frames, seen, ref
    torch.cuda.empty_cache()

    # ------------------------------------------------ (c) internvl2-26b
    vbase = get_config("internvl2-26b")
    vcfg = vbase.replace(n_layers=2, attn_impl="flash")
    vparams = lm.init_params(vcfg, torch.Generator(device=dev).manual_seed(2),
                             device=dev)
    P = vcfg.num_prefix_embeds
    prefix = torch.randn((VLM_B, P, vcfg.d_model), generator=g,
                         device=dev).to(torch.bfloat16)
    text = torch.randint(8, vcfg.vocab_size, (VLM_B, VLM_TEXT), generator=g,
                         device=dev)

    def vlm_forward(c):
        torch.cuda.synchronize()
        t0 = monotonic()
        with torch.inference_mode():
            logits, _ = lm.forward(c, vparams, text, prefix_embeds=prefix)
        torch.cuda.synchronize()
        return logits, (monotonic() - t0) * 1e3

    logits, v_ms = counted("zoo_vlm", lambda: vlm_forward(vcfg),
                           {"flash_attention"})
    if by_path["zoo_vlm"]["flash_attention"] != vcfg.n_layers:
        raise AssertionError(f"internvl2 launched {by_path['zoo_vlm']}")
    vref, _ = vlm_forward(vcfg.replace(attn_impl="flash-ref"))
    v_diff = float((logits - vref).abs().max())
    if tuple(logits.shape) != (VLM_B, P + VLM_TEXT, vcfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"internvl2 logits {tuple(logits.shape)}")
    log(f"[zoo] {vcfg.name}: {vcfg.n_layers} of {vbase.n_layers} layers, "
        f"batch {VLM_B}, {P} prefix embeddings + {VLM_TEXT} tokens: forward "
        f"{v_ms:.1f} ms; logits against plain attention: max abs diff "
        f"{v_diff:.4g} (limit {VLM_LIMIT})  [{smi}]")
    if not v_diff < VLM_LIMIT:
        raise AssertionError(f"internvl2 kernel and plain logits differ by "
                             f"{v_diff}")
    check_k4([(VLM_B, vcfg.n_heads, vcfg.n_kv_heads, P + VLM_TEXT,
               vcfg.resolved_head_dim)], "internvl2 forward")
    out["internvl2"] = dict(forward_ms=v_ms, logits_diff=v_diff)
    del vparams, logits, vref
    torch.cuda.empty_cache()
    return out


# phase 12: training at qwen1.5-0.5b's full width
TRAIN_B, TRAIN_S = 4, 4096   # train_4k's sequence length, 16,384 tokens
TRAIN_STEPS = 20
TRAIN_CKPT_EVERY = 10        # one mid-run save: ~95 s for 6 GB on an H100
                             # 80GB HBM3 (700 W) machine's host (PERF.md)
TRAIN_TIMED = 3              # steps timed by wall clock, then profiled
MFU_PEAK = PEAK_OPS_S["bfloat16"]


def phase_train(counted, by_path, log, smi, dev="cuda"):
    """Phase 12: training on the card.  (a) qwen1.5-0.5b at published
    widths and full depth, bf16 with a float32 master, random weights
    from a torch seed: launch.train's loop for 20 steps of B 4 x S 4,096
    from its PackedLoader (attn_impl "auto", full remat, loss chunks of
    1,024), a checkpoint at step 10 and at the end, deterministic
    algorithms on; the loss must fall.  (b) The step-10 checkpoint
    restored through CheckpointManager into fresh state, steps 10-19 run
    again: losses and final state equal to (a)'s, bit for bit.  Each
    save's seconds and bytes, the restore's seconds.  Then tokens/s and
    ms a step (wall, synchronised), device busy ms and idle share
    (torch.profiler), peak memory, and model FLOPs utilisation: the
    step's FLOPs counted once on meta (launch.op_cost) over the step time
    and the card's bf16 peak.  (c) The float32 smoke train step on the
    card against the CPU and the K4/K5 guards: pytest -m cuda over
    tests/test_torch_train_card.py.  (d) attn_impl="flash" under
    gradients raises here.  Paths train and train_resume launch no
    kernel."""
    import collections
    import shutil
    import subprocess

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, input_specs, smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.trainer import _grads_of
    from repro_torch.utils.timing import monotonic
    from repro_torch.utils.tree import tree_leaves, tree_param_count

    dev = torch.device(dev)
    cfg = get_config("qwen1.5-0.5b").replace(
        attn_impl="auto", remat_policy="full", loss_chunk=1024)
    oc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=TRAIN_STEPS)
    out = {}

    # (d) first, on the smoke config: the K4 guard under gradients
    scfg = smoke_config("qwen1.5-0.5b").replace(attn_impl="flash")
    sp = lm.init_params(scfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    sb = {k: torch.zeros((2, 128), dtype=torch.int32, device=dev)
          for k in ("tokens", "targets")}
    try:
        _grads_of(scfg, sp, sb)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"[train] attn_impl=\"flash\" under gradients raises: {e}")
    else:
        raise AssertionError('attn_impl="flash" trained through K4')
    del sp, sb

    # the step's FLOPs and bytes, counted once on meta
    abstract = lm.abstract_params(cfg)
    with OpCost() as cost:
        make_train_step(cfg, oc)(abstract, adamw_init(abstract, oc),
                                 input_specs(cfg, ShapeCell(
                                     "train", TRAIN_S, TRAIN_B, "train")))
    n_params = tree_param_count(abstract)
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f} M params in {cfg.dtype}; a step of "
        f"{TRAIN_B} x {TRAIN_S} counts {cost.flops / 1e12:.2f} TFLOP and "
        f"{cost.bytes / 1e9:.1f} GB of operation traffic (op_cost, full "
        f"remat)")

    left = _released(log, 12, "train")
    loader = launch_train.make_loader(cfg, TRAIN_B, TRAIN_S)
    ckpt = os.path.join(ROOT, "build", "phase12_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(12),
                            device=dev)
    torch.use_deterministic_algorithms(True)
    try:
        # (a) 20 steps through launch.train's loop
        t0 = monotonic()
        p_a, o_a, hist, mgr = counted("train", lambda: launch_train.train_loop(
            cfg, params, loader, steps=TRAIN_STEPS, ckpt_dir=ckpt,
            ckpt_every=TRAIN_CKPT_EVERY,
            mesh=Mesh(("data", "model"), (1, 1))), set())
        loop_s = monotonic() - t0
        losses_a = [float(m["loss"]) for m in hist]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        del params, hist
        state_gib = torch.cuda.memory_allocated() / 2**30 - left
        log(f"[train] (a) {TRAIN_STEPS} steps in {loop_s:.1f} s with "
            f"{len(mgr.saves)} saves {mgr.saves}; loss {losses_a[0]:.4f} -> "
            f"{losses_a[-1]:.4f} ({[round(x, 4) for x in losses_a]}); "
            f"params, master, mu and nu {state_gib:.2f} GiB, peak "
            f"{peak_gib:.2f} GiB  [{smi}]")
        if not losses_a[-1] < losses_a[0]:
            raise AssertionError(f"the loss did not fall: {losses_a}")

        # (b) restore step 10 into fresh state, run steps 10-19 again
        template = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(13), device=dev)
        template = {"params": template, "opt": adamw_init(template, oc)}
        t0 = monotonic()
        step, tree, _ = CheckpointManager(ckpt).restore(
            template, step=TRAIN_CKPT_EVERY)
        torch.cuda.synchronize()
        restore_s = monotonic() - t0
        del template
        step_fn = make_train_step(cfg, oc)

        def resume():
            p, o, losses = tree["params"], tree["opt"], []
            for s in range(step, TRAIN_STEPS):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in loader.batch_at(s).items()}
                p, o, m = step_fn(p, o, batch)
                losses.append(float(m["loss"]))
            return p, o, losses

        p_b, o_b, losses_b = counted("train_resume", resume, set())
        del tree
    finally:
        torch.use_deterministic_algorithms(False)
    same = losses_b == losses_a[TRAIN_CKPT_EVERY:] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves([p_a, o_a]),
                                          tree_leaves([p_b, o_b])))
    log(f"[train] (b) restored step {step} in {restore_s:.1f} s; steps "
        f"{step}-{TRAIN_STEPS - 1} again: losses "
        f"{[round(x, 4) for x in losses_b]}, equal to (a)'s and the final "
        f"state bit for bit: {same}")
    if not same:
        raise AssertionError(f"resumed run differs: {losses_b} against "
                             f"{losses_a[TRAIN_CKPT_EVERY:]}")
    del p_b, o_b
    shutil.rmtree(ckpt, ignore_errors=True)

    # speed, without the deterministic algorithms, on (a)'s state
    p, o = p_a, o_a
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in loader.batch_at(0).items()}

    def train_step():
        nonlocal p, o
        p, o, _ = step_fn(p, o, batch)

    train_step()
    walls = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = monotonic()
        train_step()
        torch.cuda.synchronize()
        walls.append((monotonic() - t0) * 1e3)
    step_ms = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRAIN_TIMED):
            train_step()
        torch.cuda.synchronize()
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name[:60]] += e.time_range.elapsed_us() / 1e3 / \
                TRAIN_TIMED
    if not by_kernel:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_ms = sum(by_kernel.values())
    step_launches = sum(1 for e in prof.events() if e.device_type ==
                        torch.autograd.DeviceType.CUDA) / TRAIN_TIMED
    top = [(name, round(ms, 1)) for name, ms in by_kernel.most_common(8)]
    log(f"[train] a step's kernels by device ms: {top}")
    del p, o, p_a, o_a, batch, prof
    tokens = TRAIN_B * TRAIN_S
    mfu = cost.flops / (step_ms / 1e3) / MFU_PEAK
    log(f"[train] a step of {tokens} tokens: wall {step_ms:.1f} ms (median "
        f"of {[round(w, 1) for w in walls]}) = {tokens / step_ms * 1e3:.0f} "
        f"tokens/s; kernels busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / step_ms:.4f}, {step_launches:.0f} launches; model "
        f"FLOPs utilisation {mfu:.4f} ({cost.flops / 1e12:.2f} TFLOP a step "
        f"against {MFU_PEAK / 1e12:.0f} TFLOP/s bf16)  [{smi}]")
    out["qwen"] = dict(
        params_m=n_params / 1e6, tokens_a_step=tokens,
        losses=losses_a, loop_s=loop_s, saves=mgr.saves,
        restore_s=restore_s, resume_equal=same, peak_gib=peak_gib,
        state_gib=state_gib, step_ms=step_ms, step_walls_ms=walls,
        tokens_s=tokens / step_ms * 1e3, busy_ms=busy_ms,
        idle_share=1 - busy_ms / step_ms, launches_a_step=step_launches,
        top_kernels_ms=top, flops=cost.flops, op_bytes=cost.bytes, mfu=mfu)

    # (c) the card against the CPU, and the guards, in pytest
    gc.collect()
    torch.cuda.empty_cache()
    t0 = monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
         "no:cacheprovider", os.path.join("tests", "test_torch_train_card.py")],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    log(f"[train] (c) pytest -m cuda tests/test_torch_train_card.py: rc "
        f"{run.returncode}, {tail!r} in {monotonic() - t0:.1f} s")
    if run.returncode != 0 or " passed" not in tail or "skipped" in tail:
        raise AssertionError(f"card train tests failed:\n{run.stdout[-3000:]}"
                             f"\n{run.stderr[-2000:]}")
    out["card_tests"] = tail
    return out


SHARD_STEPS = 3              # phase 13: steps of the partitioned loop
SHARD_TIMED = 2              # steps timed a side, then one profiled
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", "both"),
                ("jamba-v0.1-52b", "decode_32k", "pod"),
                # query heads kept split over KV heads that do not divide
                # the model axis; MoE, Mamba and a cache split over two
                # mesh axes at decode
                ("gemma3-12b", "train_4k", "pod"),
                ("mixtral-8x22b", "decode_32k", "pod"),
                ("falcon-mamba-7b", "decode_32k", "pod"),
                ("gemma3-12b", "long_500k", "pod"),
                # the experts at batch 1 (D split over data); whisper's
                # attention where neither its heads nor its 1,500 frames
                # divide the 16 model ranks
                ("mixtral-8x22b", "long_500k", "pod"),
                ("whisper-base", "train_4k", "pod"))
# those two: a device's FLOPs over its share of the step's (whole-step
# FLOPs / chips) may not pass the limit; the same cells traced on a CPU
# host (torch 2.13.0+cpu; python -m repro_torch.launch.dryrun) are printed
# beside the card host's: FLOPs share, compute / memory / collective ms,
# temporary GiB a device
DRYRUN_LIMITS = {("mixtral-8x22b", "long_500k", "pod"): 1.10,
                 ("whisper-base", "train_4k", "pod"): 1.15}
DRYRUN_CPU = {
    ("mixtral-8x22b", "long_500k", "pod"): (1.021, 0.001156, 0.4825, 0.1908,
                                            0.07034),
    ("whisper-base", "train_4k", "pod"): (1.000, 3.058, 162.0, 121.5, 3.792)}


def _step_times(step_fn, state, batch, log, tag):
    """Wall ms a step (synchronised), the host's ms to enqueue one (the call
    alone, before the card finishes), and the device's busy ms and idle
    share under torch.profiler (one step).  ``state`` is a one-item list
    holding (params, opt), advanced by each step."""
    import torch
    from repro_torch.utils.timing import monotonic

    def one():
        p, o = state[0]
        p, o, _ = step_fn(p, o, batch)
        state[0] = (p, o)

    walls, hosts = [], []
    for _ in range(SHARD_TIMED):
        torch.cuda.synchronize()
        t0 = monotonic()
        one()
        hosts.append((monotonic() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((monotonic() - t0) * 1e3)
    busy, launches = _busy_ms(one, 1)
    wall = min(walls)
    log(f"[sharded] {tag}: a step {wall:.1f} ms wall ({[round(w, 1) for w in walls]}), "
        f"the host enqueues it in {min(hosts):.1f} ms, kernels busy "
        f"{busy:.1f} ms, idle share {1 - busy / wall:.4f}, {launches:.0f} "
        f"launches")
    return {"step_ms": wall, "walls_ms": walls, "host_ms": min(hosts),
            "busy_ms": busy, "idle_share": 1 - busy / wall,
            "launches_a_step": launches}


def phase_sharded(counted, by_path, log, smi, dev="cuda"):
    """Phase 13: the partitioned program on the card.  (a) Phase 12's
    qwen1.5-0.5b (published widths and depth, bf16 with a float32 master,
    B 4 x S 4,096, "auto", full remat; its seed and loader) trained
    SHARD_STEPS steps by launch.train's loop on a ("data", "model") = (1,
    1) DeviceMesh over a one-rank NCCL group: parameters, optimizer state
    and batches are DTensors placed by their logical axes.  Losses, grad
    norms and the final state must equal the same steps of the
    unpartitioned step bit for bit (deterministic algorithms on, as in
    phase 12).  ms a step, the host's ms to enqueue one and the idle share,
    each side.  (b) The elastic restore: (a)'s checkpoint restored
    unsharded equals the unpartitioned state, and an unsharded checkpoint
    of the unpartitioned state (codec none) restored onto (a)'s
    placements equals (a)'s state, block for block; one step on each
    side after it, equal.  (c) The dry run in processes of their own
    (python -m repro_torch.launch.dryrun; the fake group must be its
    process's default group) for DRYRUN_CELLS: collective bytes by kind,
    the three roofline terms and the dominant one, argument and temporary
    GiB a device.  (d) pytest -m cuda tests/test_torch_sharded_card.py.
    (c) and (d) start with the phase and run beside (a) and (b); every
    process the phase starts is stopped before it returns or fails.
    Paths sharded_train and sharded_resume launch no kernel."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager, save_pytree
    from repro_torch.checkpoint.manager import _to_numpy
    from repro_torch.configs import get_config, input_logical_axes
    from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                             sharding_context,
                                             tree_placements)
    from repro_torch.distributed.rules import MeshRules
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import opt_logical_axes
    from repro_torch.utils.timing import monotonic
    from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                        tree_map)

    dev = torch.device(dev)
    cfg = get_config("qwen1.5-0.5b").replace(
        attn_impl="auto", remat_policy="full", loss_chunk=1024)
    # train_loop's optimizer for SHARD_STEPS steps
    oc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=SHARD_STEPS)
    step_fn = make_train_step(cfg, oc)
    loader = launch_train.make_loader(cfg, TRAIN_B, TRAIN_S)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in loader.batch_at(s).items()}
               for s in range(SHARD_STEPS + 1 + 2 * SHARD_TIMED)]
    build = os.path.join(ROOT, "build")
    ckpt_p = os.path.join(build, "phase13_ckpt_sharded")
    ckpt_u = os.path.join(build, "phase13_ckpt_whole")
    store = os.path.join(build, "phase13_store")
    for path in (ckpt_p, ckpt_u, store):
        shutil.rmtree(path, ignore_errors=True)
    os.makedirs(build, exist_ok=True)
    left = _released(log, 13, "sharded")
    init = lambda: lm.init_params(  # noqa: E731 phase 12's weights
        cfg, torch.Generator(device=dev).manual_seed(12), device=dev)
    out = {}
    same = lambda a, b: all(  # noqa: E731
        torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network
    t_phase = monotonic()
    # (c) and (d) run in processes of their own, started here so that they
    # overlap (a) and (b): the dry run needs the host alone, the card
    # tests little of the card, and both finish before (a)'s timed steps
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for name, argv in [
            *((f"dryrun_{arch}_{shape}", [
                "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                shape, "--mesh", meshes, "--force", "--tag", "phase13"])
              for arch, shape, meshes in DRYRUN_CELLS),
            ("card_tests", ["-m", "pytest", "-q", "-m", "cuda", "-p",
                            "no:cacheprovider", os.path.join(
                                "tests", "test_torch_sharded_card.py")])]:
        log_path = os.path.join(build, f"phase13_{name}.log")
        fh = open(log_path, "w")
        procs.append((name, log_path, fh, subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=env, text=True,
            stdout=fh, stderr=subprocess.STDOUT)))
    state_u = []  # (params, opt) of the unpartitioned steps
    try:
        torch.use_deterministic_algorithms(True)
        try:
            # the unpartitioned steps, as train_loop runs them
            params = init()
            state_u.append((params, adamw_init(params, oc)))
            hist_u = []
            for s in range(SHARD_STEPS):
                p, o, m = step_fn(*state_u[0], batches[s])
                state_u[0] = (p, o)
                hist_u.append({k: float(v) for k, v in m.items()})
            del params, p, o

            dist.init_process_group("nccl", store=dist.FileStore(store, 1),
                                    rank=0, world_size=1)
            try:
                mesh = make_local_mesh(1, 1, device=dev)
                rules = MeshRules(mesh)
                axes = {"params": lm.param_logical_axes(cfg)}
                axes["opt"] = opt_logical_axes(axes["params"], oc)

                # (a) the partitioned loop
                t0 = monotonic()
                p_p, o_p, hist, mgr = counted(
                    "sharded_train", lambda: launch_train.train_loop(
                        cfg, init(), loader, steps=SHARD_STEPS, ckpt_dir=ckpt_p,
                        ckpt_every=TRAIN_CKPT_EVERY, mesh=mesh), set())
                loop_s = monotonic() - t0
                hist_p = [{k: float(v) for k, v in m.items()} for m in hist]
                kinds = sorted({type(x).__name__ for x in tree_leaves([p_p, o_p])})
                state_p = {"params": p_p, "opt": o_p}
                whole_p = gather_tree(state_p)
                state_eq = same(whole_p, {"params": state_u[0][0],
                                          "opt": state_u[0][1]})
                metrics_eq = hist_p == hist_u
                log(f"[sharded] (a) {SHARD_STEPS} steps of train_loop on mesh "
                    f"{mesh.shape} (leaves {kinds}) in {loop_s:.1f} s with "
                    f"{mgr.saves}; loss {[round(m['loss'], 4) for m in hist_p]}, "
                    f"grad norm {[round(m['grad_norm'], 4) for m in hist_p]}; "
                    f"equal to the unpartitioned steps' metrics: {metrics_eq}, "
                    f"final state bit for bit: {state_eq}")
                if not (metrics_eq and state_eq):
                    want = dict(tree_leaves_with_path(
                        {"params": state_u[0][0], "opt": state_u[0][1]}))
                    diffs = sorted(
                        ((float((x.float() - want[k].float()).abs().max()), k)
                         for k, x in tree_leaves_with_path(whole_p)),
                        reverse=True)[:5]
                    raise AssertionError(
                        f"the partitioned steps differ: {hist_p} against "
                        f"{hist_u}; largest leaf differences {diffs}")
                del whole_p

                # (b) the elastic restore, both ways
                t0 = monotonic()
                step, back, _ = CheckpointManager(ckpt_p).restore(
                    {"params": state_u[0][0], "opt": state_u[0][1]})
                restore_p_s = monotonic() - t0
                back_eq = step == SHARD_STEPS and same(
                    back, {"params": state_u[0][0], "opt": state_u[0][1]})
                del back
                t0 = monotonic()
                save_pytree(tree_map(_to_numpy, {"params": state_u[0][0],
                                                 "opt": state_u[0][1]}),
                            os.path.join(ckpt_u, f"step_{SHARD_STEPS:08d}"),
                            codec="none")
                save_u_s = monotonic() - t0

                def resume():
                    t1 = monotonic()
                    with sharding_context(rules):
                        _, got, _ = CheckpointManager(ckpt_u).restore(
                            state_p, tree_placements(state_p, axes, rules))
                    took = monotonic() - t1
                    blocks_eq = all(
                        torch.equal(x.to_local(), y.to_local()) and
                        x.placements == y.placements
                        for x, y in zip(tree_leaves(got), tree_leaves(state_p)))
                    batch = distribute_tree(
                        batches[SHARD_STEPS],
                        input_logical_axes(batches[SHARD_STEPS]),
                        rules)
                    with sharding_context(rules):
                        p, o, m = step_fn(got["params"], got["opt"], batch)
                    return took, blocks_eq, (p, o, gather_tree(m))

                restore_u_s, blocks_eq, (p_r, o_r, m_r) = counted(
                    "sharded_resume", resume, set())
                p_w, o_w, m_w = step_fn(*state_u[0], batches[SHARD_STEPS])
                next_eq = same(gather_tree({"p": p_r, "o": o_r, "m": m_r}),
                               {"p": p_w, "o": o_w, "m": m_w})
                log(f"[sharded] (b) (a)'s checkpoint restored unsharded in "
                    f"{restore_p_s:.1f} s equals the unpartitioned state: "
                    f"{back_eq}; an unsharded checkpoint of that state (saved "
                    f"in {save_u_s:.1f} s, codec none) restored onto (a)'s "
                    f"placements in {restore_u_s:.1f} s equals (a)'s blocks: "
                    f"{blocks_eq}; the next step from each equal: {next_eq}")
                if not (back_eq and blocks_eq and next_eq):
                    raise AssertionError("an elastic restore differs")
                del p_r, o_r, m_r, p_w, o_w, m_w

                # timing, each side, from the restored states
                with sharding_context(rules):
                    part = _step_times(step_fn, [(p_p, o_p)], distribute_tree(
                        batches[-1], input_logical_axes(batches[-1]), rules),
                        log, "partitioned (1, 1)")
                whole = _step_times(step_fn, state_u, batches[-1], log,
                                    "unpartitioned")
                del p_p, o_p, state_p, mgr
            finally:
                dist.destroy_process_group()
        finally:
            torch.use_deterministic_algorithms(False)
            state_u.clear()
            for path in (ckpt_p, ckpt_u, store):
                shutil.rmtree(path, ignore_errors=True)
        log(f"[sharded] DTensor's dispatch: {part['step_ms'] - whole['step_ms']:.1f}"
            f" ms a step of wall, {part['host_ms'] - whole['host_ms']:.1f} ms of "
            f"host enqueue time ({part['launches_a_step']:.0f} against "
            f"{whole['launches_a_step']:.0f} launches)  [{smi}]")
        out["train"] = dict(steps=SHARD_STEPS, loop_s=loop_s, losses=[
            m["loss"] for m in hist_p], grad_norms=[m["grad_norm"] for m in
                                                    hist_p],
            metrics_equal=metrics_eq, state_equal=state_eq,
            restore_sharded_to_whole_s=restore_p_s, save_whole_s=save_u_s,
            restore_whole_to_mesh_s=restore_u_s, restores_equal=back_eq and
            blocks_eq and next_eq, partitioned=part, unpartitioned=whole,
            left_gib=left)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) and (d): their processes' results
        finished = {}
        for name, log_path, fh, proc in procs:
            rc = proc.wait()
            fh.flush()
            with open(log_path) as f:
                text = f.read()
            finished[name] = text
            if rc != 0:
                raise AssertionError(f"phase 13 {name}: rc {rc}\n"
                                     f"{text[-5000:]}")
        cells = {}
        for arch, shape, meshes in DRYRUN_CELLS:
            for mk in (("pod", "multipod") if meshes == "both" else (meshes,)):
                safe = arch.replace("/", "_").replace(".", "_")
                with open(os.path.join(ROOT, "build", "dryrun",
                                       f"{safe}__{shape}__{mk}__phase13.json")) \
                        as f:
                    art = json.load(f)
                t, c, mem = art["roofline_terms"], art["collectives"], \
                    art["memory"]
                log(f"[sharded] (c) {arch} x {shape} x {mk} ({art['chips']} "
                    f"ranks, torch {art['torch']}, traced in "
                    f"{art['trace_s']} s after "
                    f"{art['meta_s']} s on meta): collective bytes a device "
                    f"{c['bytes']}, "
                    f"counts {c['counts']}; collective {t['collective_s']*1e3:.2f}"
                    f" ms (wire {t['collective_wire_s']*1e3:.2f}) against compute "
                    f"{t['compute_s']*1e3:.2f} ms and memory "
                    f"{t['memory_s']*1e3:.2f} ms: {art['dominant']}; arguments "
                    f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB, temporary "
                    f"{mem['temp_size_in_bytes'] / 2**30:.3f} GiB a device")
                limit = DRYRUN_LIMITS.get((arch, shape, mk))
                if limit:
                    share = (art["cost"]["flops_per_device"] * art["chips"]
                             / art["cost"]["flops"])
                    ms = [t[k] * 1e3 for k in ("compute_s", "memory_s",
                                               "collective_s")]
                    sb = DRYRUN_CPU[(arch, shape, mk)]
                    log(f"[sharded] (c) {arch} x {shape} x {mk}: FLOPs a "
                        f"device {share:.3f}x its share (limit {limit}; "
                        f"CPU host {sb[0]:.3f}x), compute / memory / "
                        f"collective {ms[0]:.4g} / {ms[1]:.4g} / {ms[2]:.4g} "
                        f"ms (CPU host {sb[1]:.4g} / {sb[2]:.4g} / "
                        f"{sb[3]:.4g}), temporary "
                        f"{mem['temp_size_in_bytes'] / 2**30:.4g} GiB "
                        f"(CPU host {sb[4]:.4g})")
                    if share > limit:
                        raise AssertionError(
                            f"phase 13 {arch} x {shape} x {mk}: FLOPs a "
                            f"device {share:.3f}x its share, over {limit}")
                cells[f"{arch}|{shape}|{mk}"] = dict(
                    chips=art["chips"], torch=art["torch"],
                    trace_s=art["trace_s"],
                    collectives=c, roofline_terms=t, dominant=art["dominant"],
                    memory=mem, cost=art["cost"])
        out["dryrun"] = cells

        text = finished["card_tests"]
        tail = text.strip().splitlines()[-1] if text.strip() else ""
        log(f"[sharded] (d) pytest -m cuda tests/test_torch_sharded_card.py: "
            f"{tail!r}")
        if " passed" not in tail or "skipped" in tail:
            raise AssertionError(f"card sharded tests failed:\n{text[-5000:]}")
        out["card_tests"] = tail
        out["phase_s"] = monotonic() - t_phase
        log(f"[sharded] phase 13 in {out['phase_s']:.1f} s")
        return out
    finally:
        for _, _, fh, proc in procs:  # stop what a failure left running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()


def main() -> int:
    # phase 12 runs deterministic algorithms, which need cuBLAS's fixed
    # workspace; 4096 KiB x 8 is its default on Hopper, so the earlier
    # phases run as they did
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.clustering import kmeans
    from repro_torch.core.csv_filter import CSVConfig, semantic_filter
    from repro_torch.core.oracle import ModelOracle, SyntheticOracle
    from repro_torch.core.voting import default_bandwidth
    from repro_torch.data import HashTokenizer, make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
    from repro_torch.kernels.kmeans.ref import assign_clusters_ref
    from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.simvote.kernel import (
        simvote_scores_cuda, simvote_scores_segmented_cuda)
    from repro_torch.kernels.simvote.ref import (simvote_scores_ref,
                                                 simvote_scores_segmented_ref)
    from repro_torch.models import lm
    from repro_torch.obs.trace import Tracer, use_tracer
    from repro_torch.serving import ServingEngine
    from repro_torch.utils.timing import (cuda_event_ms, device_ms,
                                          monotonic, profiler_ms)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build
    t0 = t_script = t_last = monotonic()
    phase_s = {}  # wall seconds a phase took, for the log

    def mark(name):
        nonlocal t_last
        now = monotonic()
        phase_s[name] = round(now - t_last, 1)
        t_last = now

    build.library()
    log(f"[build] kernels built and loaded in {monotonic() - t0:.1f} s")
    for line in build.build_log().splitlines():
        entry = re.search(r"entry function '\w*?([a-z_]+_kernel\w*?)E+vP", line)
        if entry:  # the kernel and its template arguments, mangled
            log("[build] entry", entry.group(1))
        elif "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())

    counters = {"kmeans_assign": assign_clusters_cuda,
                "simvote_scores": simvote_scores_cuda,
                "simvote_scores_segmented": simvote_scores_segmented_cuda,
                "flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "selective_scan": selective_scan_cuda}
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
        "decode_attention": {
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:62"},
        "selective_scan": {
            "source": "src/repro_torch/csrc/selective_scan.cu",
            "replaces": None},
    }

    def note(name, err, bnd, kernel, plain, sets, cuda_name, library=None,
             library_sets=None):
        """Time the kernel, its plain version and the library call with
        device_ms over the argument tuples ``sets`` (the library call over
        ``library_sets`` where its arguments differ), one kernel call alone
        with cuda_event_ms and one launch of the CUDA kernel ``cuda_name``
        with the profiler; record them beside the bound."""
        (ms, k_ahead), (plain_ms, p_ahead) = (device_ms(fn, sets)
                                              for fn in (kernel, plain))
        library_ms, l_ahead = (None, None) if library is None else \
            device_ms(library, library_sets or sets)
        call_ms = cuda_event_ms(kernel, *sets[0])
        prof_ms = profiler_ms(kernel, sets, cuda_name)
        record[name].update(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                            bound_ms=bnd[0], bound_by=bnd[1],
                            library_ms=library_ms, call_ms=call_ms,
                            profiler_ms=prof_ms, host_ahead=k_ahead)
        log(f"[kernels] {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms "
            f"(one call alone {call_ms:.4f}, profiler a launch "
            f"{prof_ms:.4f}), plain {plain_ms:.4f} ms, library {library_ms} "
            f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}); host ahead of the card: "
            f"kernel {k_ahead}, plain {p_ahead}, library {l_ahead}  [{smi}]")

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
         bound(4 * (n * DIM + k * DIM + k) + 8 * n,
               2 * n * k * DIM + 2 * n * DIM, "float32"),
         assign_clusters_cuda, assign_clusters_ref, [(x, cents)],
         "assign_kernel")

    # K1 also at the model path's shape (n 4,096, K 4), at K 33 (three
    # passes over K) and at D 1,023 (the scalar instantiation), on rows of
    # the same table with centroids made the same way
    rng1 = np.random.default_rng(1)
    for n1, d_1, k1 in ((N_MODEL, DIM, 4), (N_DATA, DIM, 33),
                        (N_MODEL, DIM - 1, 4)):
        x1 = x[:n1, :d_1].contiguous()
        c1 = torch.stack([x1[torch.from_numpy(rng1.choice(n1, 500)).to(dev)]
                          .mean(dim=0) for _ in range(k1)])
        got_a, got_d = assign_clusters_cuda(x1, c1)
        want_a, want_d = assign_clusters_ref(x1, c1)
        torch.cuda.synchronize()
        agree = (got_a == want_a).float().mean().item()
        if agree < 0.999:
            raise AssertionError(f"K1 at n {n1}, D {d_1}, K {k1}: "
                                 f"assignments agree on {agree:.5f} < 0.999")
        torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)
        log(f"[kernels] kmeans_assign n={n1} D={d_1} K={k1}: assignments "
            f"agree on {agree:.5f}, distances within 1e-5 "
            f"(max abs err {(got_d - want_d).abs().max().item():.3g})")
    del x1, c1, got_a, got_d, want_a, want_d

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
         bound(4 * (nr * DIM + c * m * DIM + c * m + c + nr),
               2 * nr * m * DIM + 2 * (nr + c * m) * DIM, "float32"),
         simvote_scores_segmented_cuda, simvote_scores_segmented_ref,
         [seg_args], "simvote_kernel")

    # K3 also at M 300 (three sample tiles): the same clusters, 300 samples
    # each but the last, which has 250 and -1 labels after them
    ms3 = [300] * (len(groups) - 1) + [250]
    samples3 = [rng1.choice(g, mm, replace=False) for g, mm in zip(groups, ms3)]
    rests3 = [np.setdiff1d(g, s) for g, s in zip(groups, samples3)]
    s3 = np.zeros((len(groups), 300, DIM), np.float32)
    y3 = -np.ones((len(groups), 300), np.float32)
    for i, smp in enumerate(samples3):
        s3[i, :len(smp)] = ds.embeddings[smp]
        y3[i, :len(smp)] = truth[smp]
    seg3 = (torch.from_numpy(ds.embeddings[np.concatenate(rests3)]).to(dev),
            np.array([len(r) for r in rests3]), torch.from_numpy(s3).to(dev),
            torch.from_numpy(y3).to(dev),
            np.array([default_bandwidth(ds.embeddings[s]) for s in samples3]))
    r1 = simvote_scores_segmented_cuda(*seg3)
    r2 = simvote_scores_segmented_ref(*seg3)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=1e-6)
    log(f"[kernels] simvote_scores_segmented M=300 (samples {ms3}, rows "
        f"{seg3[1].tolist()}): within rtol 1e-5 atol 1e-6 (max abs err "
        f"{(r1 - r2).abs().max().item():.3g})")
    del seg3

    # K2 at a sequential-executor shape: one of those clusters alone
    xk2 = xs[:int(counts[0])]
    k2_args = (xk2, s_pad[0], y_pad[0], float(taus[0]))
    r1 = simvote_scores_cuda(*k2_args)
    r2 = simvote_scores_ref(*k2_args)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=1e-6)
    n2 = xk2.shape[0]
    note("simvote_scores", (r1 - r2).abs().max().item(),
         bound(4 * (n2 * DIM + m * DIM + m + 1 + n2),
               2 * n2 * m * DIM + 2 * (n2 + m) * DIM, "float32"),
         simvote_scores_cuda, simvote_scores_ref, [k2_args],
         "simvote_kernel")

    # K3 at the join's width: round 0 of phase 6's join, two 400-row tables
    # clustered by K1 into 4 x 4 blocks, 101 sampled pairs a block and the
    # other pairs of the 160,000 (1.3 GB at D = 2 x 1024) in one launch
    jl, jr, jtruth = join_tables(make_dataset)
    jassign = [kmeans(0, t.embeddings, 4)[1].cpu().numpy() for t in (jl, jr)]
    seg_np = join_round0(jl.embeddings, jr.embeddings, *jassign, jtruth, rng)
    segj = (torch.from_numpy(seg_np[0]).to(dev), seg_np[1],
            torch.from_numpy(seg_np[2]).to(dev),
            torch.from_numpy(seg_np[3]).to(dev), seg_np[4])
    del seg_np
    r1 = simvote_scores_segmented_cuda(*segj)
    r2 = simvote_scores_segmented_ref(*segj)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=1e-6)
    nj, dj, cj, mj = segj[0].shape[0], segj[0].shape[1], len(segj[1]), \
        segj[2].shape[1]
    bnd = bound(4 * (nj * dj + cj * mj * dj + cj * mj + cj + nj),
                2 * nj * mj * dj + 2 * (nj + cj * mj) * dj, "float32")
    (jms, j_ahead), (jplain, _) = (device_ms(fn, [segj]) for fn in (
        simvote_scores_segmented_cuda, simvote_scores_segmented_ref))
    jprof = profiler_ms(simvote_scores_segmented_cuda, [segj],
                        "simvote_kernel")
    record["simvote_scores_segmented"]["at_join_width"] = dict(
        rows=nj, clusters=cj, m=mj, d=dj,
        max_abs_err=(r1 - r2).abs().max().item(), ms=jms, profiler_ms=jprof,
        plain_ms=jplain, bound_ms=bnd[0], bound_by=bnd[1])
    log(f"[kernels] simvote_scores_segmented at the join's width ({cj} "
        f"blocks, {nj} pair rows, M {mj}, D {dj}): within rtol 1e-5 atol "
        f"1e-6 (max abs err {(r1 - r2).abs().max().item():.3g}), kernel "
        f"{jms:.4f} ms (profiler a launch {jprof:.4f}), plain {jplain:.4f} "
        f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}); host ahead {j_ahead}  [{smi}]")
    del segj, r1, r2

    # K4 at one oracle batch of llama3.1-8b: B=64, H=32, KV=8, S=64, hd=128
    B, H, KV, S, hd = 64, 32, 8, 64, 128
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(dtype, S=S):
        """(B, heads, S, hd) views of (B, S, heads, hd) tensors, as
        layers.attention_flash passes its projections."""
        return [torch.randn((B, S, heads, hd), generator=g, device=dev)
                .to(dtype).transpose(1, 2) for heads in (H, KV, KV)]

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
    # timed over four such input sets in turn, 4 x 84 MB of q, k, v and
    # output against the 50 MB L2, as each layer's inputs come from device
    # memory; the library call takes the same views
    sets = [tuple(qkv(torch.bfloat16)) for _ in range(4)]
    q, kk, v = sets[0]
    o1 = flash_attention_cuda(q, kk, v)
    o2 = flash_attention_ref(q, kk, v)
    torch.testing.assert_close(o1.float(), o2.float(), rtol=2e-2, atol=2e-2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = S * (S + 1) // 2
    note("flash_attention", (o1.float() - o2.float()).abs().max().item(),
         bound(2 * (2 * B * H * S * hd + 2 * B * KV * S * hd),
               4 * hd * pairs * B * H, "bfloat16"),
         flash_attention_cuda, flash_attention_ref, sets, "flash_tc_kernel",
         lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    del sets

    def decode_inputs(b, L, dtype, heads=H, kv_heads=KV, hd=hd):
        """q (b, H, hd); k/v as the model's (b, L, KV, hd) cache permuted
        to (b, KV, L, hd) views; ragged lengths in [1, L], 1 and L among
        them."""
        qd = torch.randn((b, heads, hd), generator=g, device=dev).to(dtype)
        kd, vd = (torch.randn((b, L, kv_heads, hd), generator=g, device=dev)
                  .to(dtype).permute(0, 2, 1, 3) for _ in range(2))
        lens = torch.randint(1, L + 1, (b,), generator=g, device=dev)
        lens[0], lens[-1] = 1, L
        return qd, kd, vd, lens.to(torch.int32)

    # K5 at the generate path's shape: B 64, H 32, KV 8, hd 128, L = the
    # 64-token bucket + 64 new-token slots = 128
    L_GEN = 128
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        dargs = decode_inputs(B, L_GEN, dtype)
        torch.testing.assert_close(decode_attention_cuda(*dargs).float(),
                                   decode_attention_ref(*dargs).float(),
                                   rtol=tol, atol=tol)
        log(f"[kernels] decode_attention {dtype} B={B} L={L_GEN}: within "
            f"{tol}")
    o1 = decode_attention_cuda(*dargs)
    o2 = decode_attention_ref(*dargs)
    # timed over four such inputs in turn, 134 MB of caches against the
    # 50 MB L2, so K/V come from device memory as each layer's do in a
    # decode step; the bound counts the first input's visible slots, and
    # the other three draw their lengths from the same distribution
    sets = [dargs] + [decode_inputs(B, L_GEN, torch.bfloat16)
                      for _ in range(3)]
    slots = torch.arange(L_GEN, device=dev)
    lib_sets = [(qd[:, :, None], kd, vd,
                 (slots[None, :] < lens[:, None])[:, None, None, :])
                for qd, kd, vd, lens in sets]
    visible = int(dargs[3].sum())
    note("decode_attention", (o1.float() - o2.float()).abs().max().item(),
         bound(2 * (2 * B * H * hd + 2 * visible * KV * hd) + 4 * B,
               4 * hd * H * visible, "bfloat16"),
         decode_attention_cuda, decode_attention_ref, sets,
         "decode_fwd_kernel",
         lambda q, k, v, mask: sdpa(q, k, v, attn_mask=mask, enable_gqa=True),
         lib_sets)
    del x, xs, s_pad, y_pad, q, kk, v, o1, o2, dargs, sets, lib_sets

    # K6 at jamba-v0.1-52b's prefill in the engine: B 64, S 32 (the
    # 32-token bucket), d_inner 8,192, d_state 16; x and z bf16, dt =
    # softplus(N(0, 1) - 4.6) (dt_bias -4.6), A_log = log(1..16), B and C
    # views of one product as the gates split it; also S 1, 17 and 300 from
    # a given state.  The plain version is the model's recurrence before
    # K6 (``selective_scan_ref``, the 32 steps as one chunk)
    def scan_inputs(S_, h0=False, b_=64, di=8192):
        f = lambda *shape: torch.randn(shape, generator=g, device=dev)
        dbc = f(b_, S_, 48)
        A = -torch.arange(1, 17, dtype=torch.float32, device=dev)
        return (torch.nn.functional.silu(f(b_, S_, di)).to(torch.bfloat16),
                torch.nn.functional.softplus(f(b_, S_, di) - 4.6),
                dbc[..., 16:32], dbc[..., 32:], f(b_, S_, di).to(
                    torch.bfloat16), A.expand(di, 16).contiguous(),
                1 + 0.1 * f(di), f(b_, di, 16) if h0 else None)

    def scan_check(args, chunk=None):
        """K6 against the plain version: h_last within 1e-5 (relative,
        and of the state's scale near 0), y within a bf16 unit, or where
        the read-out cancels near 0 within its float32 rounding (2^-20 of
        the largest output)."""
        y1, h1 = selective_scan_cuda(*args)
        y2, h2 = selective_scan_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(h1, h2, rtol=1e-5,
                                   atol=1e-5 * h2.abs().max().item())
        ulp = torch.ldexp(torch.ones_like(y2, dtype=torch.float32),
                          torch.frexp(y2.float().abs().maximum(
                              y1.float().abs()))[1] - 8).clamp(
            min=2.0 ** -20 * y2.float().abs().max().item())
        diff = (y1.float() - y2.float()).abs()
        if not (diff <= ulp).all():
            raise AssertionError(f"K6 y off by more than its tolerance: "
                                 f"{(diff / ulp).max().item():.2f} units")
        return diff.max().item(), (h1 - h2).abs().max().item()

    for S_ in (1, 17, 300):
        errs = scan_check(scan_inputs(S_, h0=True), chunk=64)
        log(f"[kernels] selective_scan S={S_} from a given state: y max abs "
            f"err {errs[0]:.3g} (within its tolerance), h_last {errs[1]:.3g}")
    sets = [scan_inputs(32) for _ in range(2)]  # 2 x 0.2 GB against the L2
    y_err, h_err = scan_check(sets[0])
    Bs, Ss, di = sets[0][0].shape
    elems = Bs * Ss * di
    # dt f32, x and z bf16 read, y bf16 and h_last f32 written, B, C, A, D
    scan_bytes = elems * (4 + 3 * 2) + Bs * di * 16 * 4 + \
        2 * Bs * Ss * 16 * 4 + di * 17 * 4
    scan_exps = elems * 17  # 16 decays and the gate's silu an element
    note("selective_scan", y_err,
         max((scan_bytes / HBM_BYTES_S * 1e3, "bytes"),
             (scan_exps / SFU_EXP_S * 1e3, "exponentials")),
         selective_scan_cuda, selective_scan_ref, sets,
         "selective_scan_kernel")
    record["selective_scan"]["h_last_max_abs_err"] = h_err
    del sets

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

    # ------------------------------------------------------- 5. generate
    gen_prompts = oracle.pack_prompts(range(N_GEN))
    tracer = Tracer()
    decoded = engine.stats["decode_tokens"]
    with use_tracer(tracer):
        streams = counted("generate", lambda: engine.generate(
            gen_prompts, max_new=MAX_NEW),
            {"flash_attention", "decode_attention"})
    launches = by_path["generate"]
    ticks = [sp for sp in tracer.spans()
             if sp.kind == "engine_tick" and sp.attrs["phase"] == "generate"]
    gen_s = sum(sp.duration_s for sp in ticks)
    decoded = engine.stats["decode_tokens"] - decoded
    n_batches = len(ticks)
    served = sorted({(sp.attrs["batch"], sp.attrs["bucket_len"])
                     for sp in ticks})
    log(f"[generate] {N_GEN} prompts, {MAX_NEW} new tokens each: "
        f"{n_batches} batches at (batch, bucket) {served}, {decoded} decode "
        f"tokens in {gen_s:.3f} s of engine_tick spans = "
        f"{decoded / gen_s:.1f} decode tokens/s  [{smi}]")
    if [len(s) for s in streams] != [MAX_NEW] * N_GEN or \
            not all(0 <= t < cfg.padded_vocab for s in streams for t in s):
        raise AssertionError("generate returned malformed streams")
    if decoded != N_GEN * MAX_NEW:
        raise AssertionError(f"{decoded} decode tokens, not {N_GEN * MAX_NEW}")
    if launches["flash_attention"] != cfg.n_layers * n_batches or \
            launches["decode_attention"] != cfg.n_layers * n_batches * MAX_NEW:
        raise AssertionError(
            f"generate launched K4 {launches['flash_attention']} and K5 "
            f"{launches['decode_attention']} times over {n_batches} batches")

    # K5 against its plain version at every (batch, cache length) served
    g.manual_seed(2)
    for b, bucket in served:
        dargs = decode_inputs(b, bucket + 64, dt, cfg.n_heads,
                              cfg.n_kv_heads, hd)
        torch.testing.assert_close(decode_attention_cuda(*dargs).float(),
                                   decode_attention_ref(*dargs).float(),
                                   rtol=2e-2, atol=2e-2)
    log(f"[generate] decode_attention within 2e-2 of its plain version at "
        f"the served (batch, cache length) shapes "
        f"{[(b, s + 64) for b, s in served]}")

    # a batch's prefill alone, timed once by hand on the first batch (the
    # engine_tick spans hold a batch's prefill and its decode steps
    # together), and the cache it leaves: decode_step on the kernel path
    # against plain attention from that cache, teacher-forced with the
    # kernel path's greedy tokens.  A control decoder runs K5 with
    # lengths - 1 (each step's own key dropped) through the same steps;
    # the limit must lie between the sound and the faulty readings.
    import repro_torch.kernels.decode_attention.ops as k5_ops
    plain_cfg = cfg.replace(attn_impl="flash-ref")
    real_k5 = k5_ops.decode_attention

    def faulty_k5(q, k, v, lengths, *, impl="auto"):
        return real_k5(q, k, v, lengths - 1, impl=impl)

    def clone(cache):  # decode_step updates a cache in place
        return [{n: {kv: t.clone() for kv, t in e.items()}
                 for n, e in sb.items()} for sb in cache]

    idx, toks, lens = next(iter(engine.batcher.plan(gen_prompts)))
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = monotonic()
        h, cache, _ = lm.prefill_hidden(cfg, params,
                                        torch.from_numpy(toks).to(dev),
                                        max_len=toks.shape[1] + 64)
        pos = torch.from_numpy(lens).to(dev)
        cur = torch.argmax(lm.hidden_logits(
            cfg, params, h[torch.arange(len(idx), device=dev), pos - 1]),
            dim=-1)
        torch.cuda.synchronize()
        prefill_s = monotonic() - t0
        del h
        ref_cache, bad_cache = clone(cache), clone(cache)
        diffs, controls = [], []
        for _ in range(3):
            got, cache = lm.decode_step(cfg, params, cache, cur, pos)
            want, ref_cache = lm.decode_step(plain_cfg, params, ref_cache,
                                             cur, pos)
            k5_ops.decode_attention = faulty_k5
            try:
                bad, bad_cache = lm.decode_step(cfg, params, bad_cache, cur,
                                                pos)
            finally:
                k5_ops.decode_attention = real_k5
            diffs.append(float((got - want).abs().max()))
            controls.append(float((bad - want).abs().max()))
            pos, cur = pos + 1, torch.argmax(got, dim=-1)
        del cache, ref_cache, bad_cache, got, want, bad
    step_ms = (gen_s / n_batches - prefill_s) / MAX_NEW * 1e3
    log(f"[generate] from the engine_tick spans less a prefill timed by hand"
        f" ({prefill_s * 1e3:.2f} ms): {step_ms:.3f} ms a decode step, "
        f"prefill share {prefill_s * n_batches / gen_s:.4f}  [{smi}]")
    log(f"[generate] decode_step logits over 3 teacher-forced steps, max abs "
        f"diff from plain attention: K5 {[f'{d:.4g}' for d in diffs]}, "
        f"control (K5 given lengths - 1) {[f'{d:.4g}' for d in controls]}")
    # bf16 rounding through 32 layers over (64, 128,256) logits: 0.084 at
    # most over 3 steps on an H100, the control 0.81-0.88 (PERF.md); the
    # limit is about the geometric mean of the two
    if not max(diffs) < DECODE_LIMIT < max(controls):
        raise AssertionError(
            f"kernel and plain decode logits differ by {max(diffs)}, the "
            f"control by {max(controls)}: the limit {DECODE_LIMIT} must lie "
            f"between them")
    plain_streams = plain.generate(gen_prompts, max_new=MAX_NEW)
    agree = np.mean([a == b for s1, s2 in zip(streams, plain_streams)
                     for a, b in zip(s1, s2)])
    log(f"[generate] the kernel and plain-attention greedy streams agree on "
        f"{agree:.4f} of {N_GEN * MAX_NEW} tokens (reported, not required: "
        f"near-ties over the vocab flip in bf16)")

    mark("1-5 build, kernels, data plane, model path, generate")

    # -------------------------------------------------------- 6. session
    session = phase_session(ds, mds, engine, tok, counted, by_path, log, smi,
                            cfg.n_layers)
    log(json.dumps({"session": session}))
    mark("6 session")

    # --------------------------------------------------------- 7. encode
    encode = phase_encode(mds, counted, log, smi)
    log(json.dumps({"encode": encode}))
    mark("7 encode")

    # -------------------------------------------------------- 8. chunked
    chunked = phase_chunked(counters, log, smi)
    log(json.dumps({"chunked": chunked}))
    mark("8 chunked")

    # -------------------------------------------------------- 9. service
    service = phase_service(mds, engine, tok, counted, by_path, log, smi,
                            cfg.n_layers)
    log(json.dumps({"service": service}))
    mark("9 service")

    # --------------------------------------------------------- 10. stream
    stream = phase_stream(ds, mds, engine, tok, counted, by_path, log, smi,
                          cfg.n_layers)
    stream.update(phase_cli(counted, by_path, log, smi))
    log(json.dumps({"stream": stream}))
    mark("10 stream")

    # ----------------------------------------------------------- 11. zoo
    # phase 4's llama3.1-8b (16 GB) and its engines go first: jamba's 16
    # layers take 52 GB
    del params, engine, plain, oracle, tracer, res, streams, plain_streams
    gc.collect()  # sessions and their tables hold the engine in cycles
    torch.cuda.empty_cache()
    zoo = phase_zoo(mds, counted, by_path, log, smi)
    log(json.dumps({"zoo": zoo}))
    mark("11 zoo")

    # ---------------------------------------------------------- 12. train
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(counted, by_path, log, smi)
    log(json.dumps({"train": train}))
    mark("12 train")

    # -------------------------------------------------------- 13. sharded
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase_sharded(counted, by_path, log, smi)
    log(f"[sharded] a step on the (1, 1) mesh "
        f"{sharded['train']['partitioned']['step_ms']:.1f} ms against phase "
        f"12's {train['qwen']['step_ms']:.1f} ms (idle share "
        f"{sharded['train']['partitioned']['idle_share']:.4f} against "
        f"{train['qwen']['idle_share']:.4f})")
    log(json.dumps({"sharded": sharded}))
    mark("13 sharded")
    log(f"[timing] wall seconds a phase {phase_s}; the script "
        f"{monotonic() - t_script:.1f} s after its imports")

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
