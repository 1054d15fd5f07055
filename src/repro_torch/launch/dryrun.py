"""Dry run on meta tensors: every (arch x shape x mesh) cell's step at
full scale, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh pod

The reference lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's analyses.  Here the step runs once on meta
tensors (``lm.abstract_params``, ``configs.input_specs``) under
``launch.op_cost.OpCost``, which counts the FLOPs and bytes of the whole
step (train: forward, backward and AdamW; prefill; or one decode step);
and the parameters, optimizer state, cache and inputs are placed on a
virtual production mesh through ``MeshRules``, each leaf divided by the
mesh axes its spec uses, for the bytes one device holds.  The roofline
terms are an H100's (989 TFLOP/s bf16 dense, 3.35 TB/s), for the step's
work split evenly over the mesh's devices; collectives are not counted
(there is no partitioned program to read them from).  Artifacts go to
``build/dryrun/``.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import pathlib
import traceback

import torch

from repro_torch.configs import (get_config, input_specs,
                                 long_context_skip_reason)
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.rules import MeshRules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import lm
from repro_torch.models.config import SHAPES
from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                         opt_logical_axes)
from repro_torch.train.trainer import make_train_step
from repro_torch.utils.timing import monotonic
from repro_torch.utils.tree import tree_leaves, tree_map

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# H100 SXM roofline denominators (NVIDIA's data sheet, 700 W)
PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # bytes/s, per card

_is_axes = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)


def _device_bytes(rules: MeshRules, axes_tree, abs_tree) -> int:
    """Bytes one device holds of ``abs_tree`` placed by ``axes_tree``."""
    total = 0

    def one(ax, leaf):
        nonlocal total
        spec = rules.spec(ax, tuple(leaf.shape))
        total += math.prod(rules.shard_shape(spec, tuple(leaf.shape))) \
            * leaf.element_size()

    tree_map(one, axes_tree, abs_tree, is_leaf=_is_axes)
    return total


def _batch_axes(specs: dict) -> dict:
    """The reference's batch placement: tokens/targets on "batch",
    modality stubs on "batch", decode positions on "kv_batch"."""
    def one(name, leaf):
        if name in ("tokens", "targets"):
            return ("batch",) + (None,) * (leaf.ndim - 1)
        if name in ("prefix_embeds", "enc_frames"):
            return ("batch", None, None)
        if name == "pos":
            return ("kv_batch",)
        return (None,) * leaf.ndim
    return {k: one(k, v) for k, v in specs.items() if k != "cache"}


def build_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None,
               oc: OptConfig = None, cfg=None, shape=None):
    """Run one (arch x shape x mesh) cell on meta; return its artifact.

    Override keys starting with "_" are launcher levers, not config
    fields (the reference's): _last_only (prefill emits last-position
    logits only), _microbatches=N (gradient accumulation),
    _serve_replicated (drop FSDP for inference when the bf16
    model-sharded weights fit comfortably).  ``cfg`` replaces
    ``get_config(arch)`` and ``shape`` replaces ``SHAPES[shape_name]`` (a
    smoke config and a small cell in tests)."""
    overrides = dict(overrides or {})
    last_only = overrides.pop("_last_only", False)
    microbatches = overrides.pop("_microbatches", 1)
    serve_repl = overrides.pop("_serve_replicated", False)
    overrides.pop("_donate", None)  # the reference's buffer donation
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES[shape_name]
    art = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "overrides": dict(overrides, _last_only=last_only,
                             _microbatches=microbatches,
                             _serve_replicated=serve_repl),
           "ok": False}

    if shape_name == "long_500k":
        reason = long_context_skip_reason(arch)
        if reason:
            art.update(skipped_by_design=True, reason=reason, ok=True)
            return art

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                virtual=True)
    rules = MeshRules(mesh)
    if serve_repl and shape.kind != "train":
        shard_gb = cfg.param_count() * 2 / mesh.shape["model"] / 1e9
        if shard_gb < 8.0:
            rules.rules["embed"] = []  # replicate weights across data axis
            art["serve_replicated_applied"] = True
    chips = mesh.size

    p_axes = lm.param_logical_axes(cfg)
    params = lm.abstract_params(cfg)
    specs = input_specs(cfg, shape)
    per_device = {"params": _device_bytes(rules, p_axes, params),
                  "inputs": _device_bytes(rules, _batch_axes(specs),
                                          {k: v for k, v in specs.items()
                                           if k != "cache"})}

    t0 = monotonic()
    with sharding_context(rules), OpCost() as cost:
        if shape.kind == "train":
            oc = oc or OptConfig()
            opt = adamw_init(params, oc)
            o_axes = opt_logical_axes(p_axes, oc)
            per_device["opt"] = _device_bytes(rules, o_axes, opt)
            make_train_step(cfg, oc, microbatches=microbatches)(
                params, opt, specs)
        elif shape.kind == "prefill":
            with torch.no_grad():
                _, cache, _ = lm.prefill(
                    cfg, params, specs["tokens"],
                    prefix_embeds=specs.get("prefix_embeds"),
                    enc_frames=specs.get("enc_frames"),
                    max_len=shape.seq_len, last_only=last_only)
            per_device["cache"] = _device_bytes(
                rules, lm.cache_logical_axes(cfg), cache)
        else:  # decode
            cache = specs["cache"]
            per_device["cache"] = _device_bytes(
                rules, lm.cache_logical_axes(
                    cfg, long_context=shape_name == "long_500k"), cache)
            with torch.no_grad():
                lm.decode_step(cfg, params, cache, specs["tokens"],
                               specs["pos"])
    trace_s = monotonic() - t0

    terms = {"compute_s": cost.flops / chips / PEAK_FLOPS,
             "memory_s": cost.bytes / chips / HBM_BW,
             "collective_s": None}
    art.update(
        ok=True, chips=chips, trace_s=round(trace_s, 2),
        cost={"flops": cost.flops, "bytes": cost.bytes,
              "flops_per_device": cost.flops / chips,
              "bytes_per_device": cost.bytes / chips},
        per_device_bytes=per_device, roofline_terms=terms,
        dominant=max(("compute_s", "memory_s"), key=lambda k: terms[k]),
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        param_leaves=len(tree_leaves(params)),
        sharding_warnings=sorted(set(rules.warnings)),
    )
    return art


def cell_path(arch, shape_name, mesh_kind, tag="baseline") -> pathlib.Path:
    safe = arch.replace("/", "_").replace(".", "_")
    return ART_DIR / f"{safe}__{shape_name}__{mesh_kind}__{tag}.json"


ASSIGNED = ["falcon-mamba-7b", "mixtral-8x22b", "dbrx-132b", "internvl2-26b",
            "gemma3-12b", "stablelm-12b", "codeqwen1.5-7b", "qwen1.5-0.5b",
            "jamba-v0.1-52b", "whisper-base"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true", help="all 40 assigned cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb lever)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    ART_DIR.mkdir(parents=True, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ASSIGNED for s in SHAPES for m in meshes]
    else:
        archs = [args.arch] if args.arch else ASSIGNED
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    n_ok = n_fail = 0
    for arch, shape_name, mesh_kind in cells:
        path = cell_path(arch, shape_name, mesh_kind, args.tag)
        if path.exists() and not args.force:
            print(f"skip (exists): {path.name}")
            continue
        print(f"=== {arch} x {shape_name} x {mesh_kind} [{args.tag}] ===",
              flush=True)
        try:
            art = build_cell(arch, shape_name, mesh_kind, overrides or None)
        except Exception as e:  # noqa: BLE001 - a failed cell is an artifact
            art = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        art["tag"] = args.tag
        path.write_text(json.dumps(art, indent=1))
        if art.get("ok"):
            n_ok += 1
            if art.get("skipped_by_design"):
                print(f"  SKIP-BY-DESIGN: {art['reason']}")
            else:
                t, b = art["roofline_terms"], art["per_device_bytes"]
                print(f"  ok trace={art['trace_s']}s "
                      f"flops/dev={art['cost']['flops_per_device']:.3e} "
                      f"compute={t['compute_s']*1e3:.2f}ms "
                      f"memory={t['memory_s']*1e3:.2f}ms "
                      f"dominant={art['dominant']}", flush=True)
                print("  bytes/device:", b, flush=True)
        else:
            n_fail += 1
            print(f"  FAIL: {art['error']}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
