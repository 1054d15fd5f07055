#!/usr/bin/env python3
"""Time K1 (k-means assignment), K2 and K3 (SimVote) of one source tree of
the port, on one NVIDIA GPU.

    python3 scripts/time_kmeans_simvote.py [ROOT]

ROOT is the root of a checkout (default: this one), so that two trees can
be compared in one process each on the same card, in turns (parent,
change, change, parent).  Printed, each beside the card's name and power
limit, for every kernel: device time a call with the host ahead of the
card (utils.timing.device_ms; "host ahead: False" flags a wrapper that
held the host back) and the profiler's device time a launch
(utils.timing.profiler_ms), at two sizes:

- main: the shapes of chip_smoke.py phase 2 (make_dataset("imdb_review",
  n=50,000, dim=1024)): K1 over x (50,000, 1024) f32 with 4 centroids;
  K3 over the four clusters of that assignment less 101 samples each,
  M 101; K2 over the first of them alone;
- large: a table of 400,000 rows x 1024 f32 (1.6 GB) in 4 clusters of
  100,000: K1 with 4 centroids; K3 with 500 samples a cluster (M 500, the
  sample of a 100,000-row cluster at xi 0.005) over the other 99,500 rows
  of each; K2 over one such cluster.

Where the tree's SimVote wrapper picks the rows a block
(``simvote.kernel.block_rows``), K2 and K3 are also timed at each block
height, with that choice replaced, beside the one the wrapper picks.
As a yardstick, one f32 matrix product of K3's size (all its rows against
one cluster's samples, torch.matmul with TF32 off) is timed too: the
product alone, without the norms, the weights or the vote.  It needs a
card.
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
N_MAIN, DIM, M_MAIN = 50_000, 1024, 101
N_LARGE, C_LARGE, M_LARGE = 400_000, 4, 500


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_kmeans_simvote: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.voting import default_bandwidth
    from repro_torch.data import make_dataset
    from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
    from repro_torch.kernels.simvote import kernel as simvote_kernel
    from repro_torch.kernels.simvote.kernel import (
        simvote_scores_cuda, simvote_scores_segmented_cuda)
    from repro_torch.utils.timing import device_ms, profiler_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    pick_rows = getattr(simvote_kernel, "block_rows", None)
    print(f"tree {ROOT}  [{smi}]")

    def report(size, name, fn, args, cuda_name, tag=""):
        ms, ahead = device_ms(fn, [args])
        prof = profiler_ms(fn, [args], cuda_name)
        print(f"{size} {name}{tag}: {ms:.4f} ms a call (host ahead: "
              f"{ahead}), profiler {prof:.4f} ms a launch  [{smi}]",
              flush=True)

    def simvote_all(size, seg_args, k2_args):
        xs, _, s_pad = seg_args[:3]
        torch.backends.cuda.matmul.allow_tf32 = False
        st = s_pad[0].T.contiguous()
        mm, _ = device_ms(torch.matmul, [(xs, st)])
        n, d = xs.shape
        print(f"{size} product alone ({n} x {d}) @ ({d} x {st.shape[1]}) "
              f"f32: {mm:.4f} ms a call  [{smi}]", flush=True)
        for rows in [None] + ([32, 64] if pick_rows else []):
            if rows is not None:  # every block takes this many rows
                simvote_kernel.block_rows = lambda counts, sms: rows
            tag = f" rows={rows}" if rows else ""
            report(size, "K3", simvote_scores_segmented_cuda, seg_args,
                   "simvote_kernel", tag)
            report(size, "K2", simvote_scores_cuda, k2_args,
                   "simvote_kernel", tag)
            if pick_rows:
                simvote_kernel.block_rows = pick_rows

    # main: chip_smoke.py phase 2's data and shapes
    rng = np.random.default_rng(0)
    ds = make_dataset("imdb_review", n=N_MAIN, dim=DIM)
    truth = ds.labels["RV-Q1"]
    x = torch.from_numpy(ds.embeddings).to(dev)
    cents = torch.stack([x[torch.from_numpy(rng.choice(N_MAIN, 500)).to(dev)]
                         .mean(dim=0) for _ in range(4)])
    report("main", "K1", assign_clusters_cuda, (x, cents), "assign_kernel")
    assign = assign_clusters_cuda(x, cents)[0].cpu().numpy()
    groups = [np.nonzero(assign == c)[0] for c in range(4)]
    groups = [g for g in groups if len(g) > M_MAIN]
    samples = [rng.choice(g, M_MAIN, replace=False) for g in groups]
    rests = [np.setdiff1d(g, s) for g, s in zip(groups, samples)]
    counts = np.array([len(r) for r in rests])
    xs = torch.from_numpy(ds.embeddings[np.concatenate(rests)]).to(dev)
    s_pad = torch.from_numpy(np.stack([ds.embeddings[s]
                                       for s in samples])).to(dev)
    y_pad = torch.from_numpy(np.stack([truth[s].astype(np.float32)
                                       for s in samples])).to(dev)
    taus = np.array([default_bandwidth(ds.embeddings[s]) for s in samples])
    print(f"main: K3 counts {counts.tolist()}, M {M_MAIN}; K2 "
          f"{int(counts[0])} rows")
    simvote_all("main", (xs, counts, s_pad, y_pad, taus),
                (xs[:int(counts[0])], s_pad[0], y_pad[0], float(taus[0])))
    del x, xs, s_pad, y_pad, ds

    # large: 400,000 x 1024 f32 in 4 clusters around random centres
    g = torch.Generator(device=dev).manual_seed(0)
    per = N_LARGE // C_LARGE
    centres = torch.randn((C_LARGE, DIM), generator=g, device=dev)
    x = torch.randn((N_LARGE, DIM), generator=g, device=dev) \
        + centres.repeat_interleave(per, dim=0)
    report("large", "K1", assign_clusters_cuda, (x, centres), "assign_kernel")
    xv = x.view(C_LARGE, per, DIM)
    s_pad = xv[:, :M_LARGE].contiguous()
    xs = xv[:, M_LARGE:].reshape(-1, DIM)
    del x, xv
    y_pad = (torch.rand((C_LARGE, M_LARGE), generator=g, device=dev)
             < 0.5).float()
    counts = np.full(C_LARGE, per - M_LARGE)
    taus = np.full(C_LARGE, float(np.sqrt(2 * DIM)))
    print(f"large: K3 counts {counts.tolist()}, M {M_LARGE}; K2 "
          f"{per - M_LARGE} rows")
    simvote_all("large", (xs, counts, s_pad, y_pad, taus),
                (xs[:per - M_LARGE], s_pad[0], y_pad[0], float(taus[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
