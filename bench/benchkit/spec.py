"""The benchmark's data files: BENCHMARK.json, a configuration, a traffic
mix and a configuration's correctness limits, each found by name, and
the architecture module a configuration names.

A configuration file holds the published config's keys (Hugging Face
names) as they are run, the keys changed from the source in ``reduced``,
the sizes set here in ``assumed``, a ``serving`` group with what the
program is told besides (its dtype, attention path, MoE capacity, engine
batch), and optionally ``arch``, the module under ``bench/archs`` that
reads its layout (``decoder`` by default).
"""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
ARCHS = BENCH / "archs"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload entry, its configuration and its mix, by name."""
    bm = benchmark()
    wl = next((w for w in bm["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bm["configs"] if c["name"] == wl["config"])
    return {"workload": wl, "config": load_json(ROOT / conf["file"]),
            "mix": load_json(BENCH / "mixes" / f"{wl['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{wl['config']}.json"),
            "benchmark": bm}


def load_module(path, name: str):
    """A module of the benchmark's own, loaded from its file by path."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def arch(conf: dict):
    """The architecture module a configuration names under ``"arch"``:
    ``ARCHS/<name>.py``, ``decoder`` where it names none.  It gives the
    flat sizes (``dims``, with ``layers`` as [(mixer, ffn)]), the
    program's config (``program_config``), the cut to CPU test size
    (``smoke``), the weights (``make_params``, ``layer_list``), the
    plain float32 reference (``yes_no_logits``) and the FLOP count
    (``prefill_flops``), so that a new architecture is new files only."""
    name = conf.get("arch", "decoder")
    return load_module(ARCHS / f"{name}.py", f"bench_arch_{name}")


def period(kinds: list) -> int:
    """The shortest prefix length whose repetition gives ``kinds``."""
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and kinds == kinds[:p] * (n // p):
            return p
    return n


def capacity(K: int, T: int, E: int, cf: float) -> int:
    """Slots an expert takes of a sequence of T tokens (GShard capacity,
    rounded up to 8, at most T): the configuration's routing semantics."""
    c = max(1, int(K * T / E * cf))
    return min((c + 7) // 8 * 8, T)


def sample_size(m: int, xi: float, min_sample: int) -> int:
    """Paper section 4.1: max(ceil(xi * m), min_sample), at most m."""
    return min(m, max(min_sample, math.ceil(xi * m)))
