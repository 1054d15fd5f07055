"""The benchmark's data files: BENCHMARK.json, a configuration, a traffic
mix and a configuration's correctness limits, each found by name.

A configuration file holds the published config's keys (Hugging Face
names) as they are run, the keys changed from the source in ``reduced``,
the sizes set here in ``assumed``, and a ``serving`` group with what the
program is told besides (its dtype, attention path, MoE capacity, engine
batch).  ``layer_kinds`` turns the published layout keys into one entry
per layer, the form that both the program's config and the plain
reference are built from.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


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


def layer_kinds(conf: dict) -> list:
    """[(mixer, ffn)] for every layer: mixer "attn" or "mamba", ffn
    "dense" or "moe", from Jamba-style period/offset keys (a config
    without them is attention and dense throughout)."""
    n = conf["num_hidden_layers"]
    out = []
    for i in range(n):
        mixer = "attn"
        if "attn_layer_period" in conf:
            p, o = conf["attn_layer_period"], conf["attn_layer_offset"]
            mixer = "attn" if i % p == o else "mamba"
        ffn = "dense"
        if conf.get("num_experts", 1) > 1:
            p, o = conf["expert_layer_period"], conf["expert_layer_offset"]
            ffn = "moe" if i % p == o else "dense"
        out.append((mixer, ffn))
    return out


def dims(conf: dict) -> dict:
    """The sizes both sides use, in one flat dict."""
    D = conf["hidden_size"]
    H = conf["num_attention_heads"]
    d = {"D": D, "H": H, "KV": conf["num_key_value_heads"],
         "hd": conf.get("head_dim") or D // H,
         "F": conf["intermediate_size"], "V": conf["vocab_size"],
         "E": conf.get("num_experts", 1), "K": conf.get("num_experts_per_tok", 1),
         "eps": conf["rms_norm_eps"], "theta": conf["rope_theta"],
         "tied": conf["tie_word_embeddings"],
         "cf": conf["serving"]["capacity_factor"],
         "layers": layer_kinds(conf)}
    if "mamba_d_state" in conf:
        d.update(ds=conf["mamba_d_state"], dc=conf["mamba_d_conv"],
                 di=conf["mamba_expand"] * D, dr=conf["mamba_dt_rank"])
    d["Vp"] = (d["V"] + 127) // 128 * 128   # the program pads its table
    return d


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
