"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's cards.  The
cell, its configuration, its traffic mix and its limits are found by
name from ``BENCHMARK.json``; ``--trace 0`` reports the end-to-end
metrics, ``--trace 1`` the per-layer ones (the program's spans and
counters and a device trace of the window).  Both check what the window
produced against the plain reference and print each compared number
beside its limit, as the last lines of standard error and under the
result line's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _environment() -> None:
    """Caches at fixed paths inside the checkout; the program's own nvcc
    build lives in ``build/kernels-<digest>``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run(cell_spec: dict, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float = None) -> dict:
    """One run: set-up, window, check -> the result line's dict."""
    import torch

    from benchkit import cell as C
    from benchkit.devtrace import DeviceTrace

    t_start = T_START if t_start is None else t_start
    bm = cell_spec["benchmark"]
    name = cell_spec["workload"]["name"]
    cell = C.Cell(cell_spec, device)
    cell.build(seed)
    tracer = dtrace = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
        dtrace = DeviceTrace() if cell.device.type == "cuda" else None
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    setup_s = time.perf_counter() - t_start
    win = cell.window(seconds, tracer, dtrace)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    values = dict(C.end_to_end(win, cell.table.n), setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in bm["end_to_end"] + bm["per_layer"]}
    metrics = {}
    if trace:
        ctx = _Context(cell, win, tracer, dtrace)
        for m in bm["per_layer"]:
            if name in m.get("workloads", [name]):
                v = C.load_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in bm["end_to_end"]:
            if name in m.get("workloads", [name]):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": units[m["name"]]}
    cell.release()
    numbers = C.csv_numbers(cell, win, seed)
    numbers.update(C.logit_numbers(cell, win["queries"], seed))
    checks = C.checks(numbers, cell.limits)
    out = {"correct": all(ok for *_, ok in checks),
           "attempted": len(win["queries"]), "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if cell.device.type == "cuda"
                      else cell.device.type,
                      "kind": (torch.cuda.get_device_name(cell.device)
                               if cell.device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if dtrace is not None:
        out["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        out["breakdown"] = {"device_ops": dtrace.device_ops(),
                            "idle_gaps": dtrace.idle_gaps(tracer.spans())}
    out["info"] = {k: v for k, v in numbers.items()
                   if k not in cell.limits["compare"]}
    out["info"].update(values)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim, _ in checks}
    return out


class _Context:
    """What the per-layer readers read: the window's queries and counts,
    the program's spans, the device trace, the served prompt lengths, the
    cell's sizes and its architecture module."""

    def __init__(self, cell, win, tracer, dtrace):
        self.arch, self.d = cell.arch, cell.d
        self.win = win
        self.spans = tracer.spans()
        self.trace = dtrace
        self.lens = [len(p) for r in win["queries"]
                     for ids in r["oracle"].asked
                     for p in r["oracle"].pack_prompts(ids)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from benchkit import spec
    cell_spec = spec.cell(args.workload)
    import torch
    chips = cell_spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(cell_spec, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"modules of the JAX package or of JAX were loaded: {bad}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
