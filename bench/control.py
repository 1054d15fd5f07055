"""Readings for the limits of a cell's check, on the chip at the cell's
own size: for each seed, the program's numbers over a short window of
``check.queries`` queries (as many as a run compares), then, for the
control seeds, the control's on the same prompts and labels: the
reference put in the program's place in the precision below the
configuration's (bfloat16 -> float8 e4m3 for the model, float32 -> TF32
for the distance products of k-means and SimVote).

    python3 bench/control.py --workload <name> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--dump DIR]

Prints one JSON line a seed and side: the compared numbers, and beside
them the served logits' error quantiles over every sampled prompt.
``--dump`` writes each seed's per-prompt errors and routing excesses to
``DIR/<workload>_<seed>.npz``.  The limits under ``bench/limits`` are
set from these readings (PERF.md gives them).  The benchmark's own runs
do not run this.
"""
import argparse
import gc
import json
import os
import sys
import time

import numpy as np

import run as R


def quantiles(e: dict) -> dict:
    """The logit errors' quantiles over the sampled prompts, and the
    routing's largest excess over the reference's router."""
    out = {f"err_{k}": float(np.percentile(e["err"], q)) for k, q in
           (("p10", 10), ("median", 50), ("p90", 90))}
    out["excess_max"] = float(e["excess"].max())
    return out


def control_side(cell, queries: list, win: dict, seed: int):
    """The check's numbers with the reference in lower precision put in
    the program's place, and its logit errors."""
    from benchkit import cell as C
    from benchkit import csv_ref
    layers = cell.arch.layer_list(cell.params)

    def fp8(toks, lens, tid):
        route = C.reference.Route()
        out = cell.arch.yes_no_logits(cell.d, cell.params, layers, toks,
                                      lens, tid, precision="fp8",
                                      route=route)
        return out.cpu().numpy(), route.chosen or None

    pol = cell.mix["policy"]
    emb = cell.table.emb.double()
    a32, _ = csv_ref.kmeans(pol["seed"], emb, cell.table.emb_host,
                            pol["n_clusters"], pol["kmeans_iters"],
                            csv_ref.plusplus, "tf32")

    def tf32(labels):
        return csv_ref.csv_filter(emb, cell.table.emb_host, labels, a32, pol,
                                  csv_ref.plusplus, "tf32")

    nums = C.csv_numbers(cell, dict(win, assign=a32), seed, program=tf32)
    e = C.logit_errors(cell, queries, seed, program=fp8)
    nums.update(C.logit_stat(cell, e))
    return nums, e


def control_numbers(cell, queries: list, win: dict, seed: int) -> dict:
    return control_side(cell, queries, win, seed)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--dump", default=None)
    args = p.parse_args(argv)
    R._environment()
    from benchkit import cell as C
    from benchkit import spec
    cs = spec.cell(args.workload)
    cell = C.Cell(cs, "cuda")
    n_q = cs["mix"]["check"]["queries"]
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell.build(seed)
        with cell.recording():
            queries = [cell.query(q, cell.labels_of(q)) for q in range(n_q)]
        win = {"queries": queries,
               "served": sum(r["calls"] for r in queries),
               "assign": cell.handle.precluster(
                   cs["mix"]["policy"]["n_clusters"],
                   cs["mix"]["policy"]["seed"])}
        cell.release()
        nums = C.csv_numbers(cell, win, seed)
        e = C.logit_errors(cell, queries, seed)
        nums.update(C.logit_stat(cell, e), **quantiles(e))
        print(json.dumps({"side": "program", "seed": seed, **nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
        dump = {"err": e["err"], "excess": e["excess"]}
        if seed in args.control_seeds:
            nums, ec = control_side(cell, queries, win, seed)
            print(json.dumps({"side": "control", "seed": seed, **nums,
                              **quantiles(ec)}), flush=True)
            dump.update(err_control=ec["err"], excess_control=ec["excess"])
        if args.dump:
            np.savez_compressed(os.path.join(
                args.dump, f"{args.workload}_{seed}.npz"), **dump)
        # the queries' oracles hold the engine, and it the weights
        del queries, win
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
