"""Dry run: every (arch x shape x mesh) cell's step as a partitioned
program at full scale, with nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh pod

The reference lowers and compiles each cell for 256 or 512 forced host
devices under ``in_shardings``/``out_shardings`` and reads XLA's
analyses of the partitioned program.  Here the cell's step runs as a
DTensor program on a ``fake`` process group of 256 (512) ranks
(``launch.mesh.virtual_device_mesh``) whose local shards are meta
tensors: this process is rank 0 and holds rank 0's shards, which have
shapes but no storage, and the collectives run but move nothing.
Inputs and outputs are placed as the reference's shardings place them
(train: parameters and optimizer state by their logical axes with the
step replicated, the batch by ``configs.input_logical_axes``, the
metrics replicated; prefill: logits, cache and positions; decode:
logits and cache).  The artifact carries:

- ``collectives``: bytes, wire bytes and counts of every kind the
  program ran, the reference's byte rules (``launch.collectives``), and
  the program's functions that issued the most bytes (``sites``);
- ``memory``: argument, output and temporary bytes of one device: the
  local shards of the inputs, of the placed outputs, and the peak of
  the bytes the step's own storages held at once;
- ``cost``: the unpartitioned step's FLOPs and bytes (counted once, on
  meta tensors) and one device's, counted on its local shards (so
  replicated work counts on every device), with the functions and
  operations that ran the most FLOPs and bytes on it and those whose
  storages held the most at its peak (``OpCost.top_sites``);
- ``roofline_terms``: compute, memory and collective time of one device
  and the dominant of the three, against an H100 SXM's 989 TFLOP/s bf16
  dense and 3.35 TB/s, and for collectives the 50 GB/s a DGX H100 gives
  each GPU off its node (one ConnectX-7 NDR 400 Gb/s port per GPU, a
  direction): every group of the (16, 16) and (2, 16, 16) meshes spans
  more than one 8-GPU node, so off-node links carry each collective.

``per_device_bytes`` gives the same placements' bytes by tree, from the
rules' shard shapes.  Artifacts go to ``build/dryrun/``.  The fake group
is the process's default group, so a cell runs where no other group
exists: the CLI, or a process of its own.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import pathlib
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (get_config, input_logical_axes,
                                 input_specs, long_context_skip_reason)
from repro_torch.distributed.api import (distribute_tree, partitioned,
                                         sharding_context)
from repro_torch.distributed.rules import MeshRules
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import make_production_mesh, virtual_device_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import lm
from repro_torch.models.config import SHAPES
from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                         opt_logical_axes)
from repro_torch.train.trainer import make_train_step
from repro_torch.utils.timing import monotonic
from repro_torch.utils.tree import tree_leaves, tree_map

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# roofline denominators, one H100 SXM (NVIDIA's data sheets, 700 W)
PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # bytes/s, per card
# a GPU's network off its node: DGX H100 gives each GPU one ConnectX-7
# NDR 400 Gb/s port, 50 GB/s a direction; every group of the production
# meshes spans several 8-GPU nodes, so off-node links carry each
# collective (NVLink's 450 GB/s a direction serves only groups within a
# node)
NET_BW = 50e9

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


def _local_bytes(tree) -> int:
    """Bytes of this rank's local shards of a tree's DTensor leaves."""
    return sum(math.prod(t.to_local().shape) * t.element_size()
               for t in tree_leaves(tree))


def _replicated_axes(tree):
    return tree_map(lambda t: (None,) * t.ndim, tree)


def _place_inputs(cfg, shape, shape_name, rules, params, specs, oc,
                  p_axes):
    """The cell's arguments placed as the reference's ``in_shardings``
    place them: a tuple of trees of DTensors."""
    dp = distribute_tree(params, p_axes, rules)
    if shape.kind == "train":
        opt = distribute_tree(adamw_init(params, oc),
                              opt_logical_axes(p_axes, oc), rules)
        return dp, opt, distribute_tree(specs, input_logical_axes(specs),
                                        rules)
    if shape.kind == "prefill":
        return dp, distribute_tree(specs, input_logical_axes(specs), rules)
    cache = distribute_tree(specs["cache"], _cache_axes(cfg, shape_name),
                            rules)
    return dp, cache, {k: distribute_tree(specs[k], ("kv_batch",), rules)
                       for k in ("tokens", "pos")}


def _cache_axes(cfg, shape_name):
    return lm.cache_logical_axes(cfg,
                                 long_context=shape_name == "long_500k")


def _partitioned_step(cfg, shape, shape_name, rules, args, oc, microbatches,
                      last_only, p_axes):
    """Run the cell's step on its placed arguments and place its outputs
    as the reference's ``out_shardings`` do -> a tuple of trees of
    DTensors."""
    dp = args[0]
    if shape.kind == "train":
        _, opt, batch = args
        with partitioned(dp):
            new_p, new_o, metrics = make_train_step(
                cfg, oc, microbatches=microbatches)(dp, opt, batch)
            return (distribute_tree(new_p, p_axes, rules),
                    distribute_tree(new_o, opt_logical_axes(p_axes, oc),
                                    rules),
                    distribute_tree(metrics, _replicated_axes(metrics),
                                    rules))
    if shape.kind == "prefill":
        batch = args[1]
        with partitioned(dp), torch.no_grad():
            logits, cache, pos = lm.prefill(
                cfg, dp, batch["tokens"],
                prefix_embeds=batch.get("prefix_embeds"),
                enc_frames=batch.get("enc_frames"),
                max_len=shape.seq_len, last_only=last_only)
            logit_axes = (("batch", "vocab") if last_only
                          else ("batch", None, "vocab"))
            return (distribute_tree(logits, logit_axes, rules),
                    distribute_tree(cache, lm.cache_logical_axes(cfg),
                                    rules),
                    distribute_tree(pos, ("kv_batch",), rules))
    _, cache, tok = args
    with partitioned(dp), torch.no_grad():
        logits, cache = lm.decode_step(cfg, dp, cache, tok["tokens"],
                                       tok["pos"])
        return (distribute_tree(logits, ("kv_batch", "vocab"), rules),
                distribute_tree(cache, _cache_axes(cfg, shape_name), rules))


def _unpartitioned_cost(cfg, shape, params, specs, oc, microbatches,
                        last_only) -> OpCost:
    """The whole step's FLOPs and bytes, on meta tensors."""
    with OpCost() as cost:
        if shape.kind == "train":
            make_train_step(cfg, oc, microbatches=microbatches)(
                params, adamw_init(params, oc), specs)
        elif shape.kind == "prefill":
            with torch.no_grad():
                lm.prefill(cfg, params, specs["tokens"],
                           prefix_embeds=specs.get("prefix_embeds"),
                           enc_frames=specs.get("enc_frames"),
                           max_len=shape.seq_len, last_only=last_only)
        else:
            with torch.no_grad():
                lm.decode_step(cfg, params, specs["cache"], specs["tokens"],
                               specs["pos"])
    return cost


def build_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None,
               oc: OptConfig = None, cfg=None, shape=None):
    """Build one (arch x shape x mesh) cell as a partitioned program on a
    virtual mesh; return its artifact.

    Override keys starting with "_" are launcher levers, not config
    fields (the reference's): _last_only (prefill emits last-position
    logits only), _microbatches=N (gradient accumulation),
    _serve_replicated (drop FSDP for inference when the bf16
    model-sharded weights fit comfortably).  ``cfg`` replaces
    ``get_config(arch)`` and ``shape`` replaces ``SHAPES[shape_name]`` (a
    smoke config and a small cell in tests).  The cell makes this
    process's default process group (a ``fake`` one) and destroys it on
    return; it raises if a default group exists already."""
    overrides = dict(overrides or {})
    last_only = overrides.pop("_last_only", False)
    microbatches = overrides.pop("_microbatches", 1)
    serve_repl = overrides.pop("_serve_replicated", False)
    overrides.pop("_donate", None)  # the reference's buffer donation
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES[shape_name]
    oc = oc or OptConfig()
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

    layout = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                  virtual=True)
    chips = layout.size
    p_axes = lm.param_logical_axes(cfg)
    params = lm.abstract_params(cfg)
    specs = input_specs(cfg, shape)

    t0 = monotonic()
    total = _unpartitioned_cost(cfg, shape, params, specs, oc, microbatches,
                                last_only)
    meta_s = monotonic() - t0

    mesh = virtual_device_mesh(layout)
    try:
        rules = MeshRules(mesh)
        if serve_repl and shape.kind != "train":
            shard_gb = cfg.param_count() * 2 / mesh.shape["model"] / 1e9
            if shard_gb < 8.0:
                rules.rules["embed"] = []  # replicate weights across data
                art["serve_replicated_applied"] = True
        per_device = {"params": _device_bytes(rules, p_axes, params),
                      "inputs": _device_bytes(rules, input_logical_axes(specs),
                                              {k: v for k, v in specs.items()
                                               if k != "cache"})}
        if shape.kind == "train":
            per_device["opt"] = _device_bytes(
                rules, opt_logical_axes(p_axes, oc), adamw_init(params, oc))

        t0 = monotonic()
        with sharding_context(rules):
            # the arguments are placed before the counters start: their
            # blocks are neither the step's work nor its temporaries
            args = _place_inputs(cfg, shape, shape_name, rules, params,
                                 specs, oc, p_axes)
            with OpCost(given=args) as cost, CollectiveCounter() as coll:
                outs = _partitioned_step(
                    cfg, shape, shape_name, rules, args, oc, microbatches,
                    last_only, p_axes)
            arg_bytes, out_bytes = _local_bytes(args), _local_bytes(outs)
            if shape.kind == "prefill":
                per_device["cache"] = _local_bytes(outs[1])
            elif shape.kind == "decode":
                per_device["cache"] = _local_bytes(args[1])
            del args, outs
        trace_s = monotonic() - t0
    finally:
        dist.destroy_process_group()

    collectives = dict(coll.report(), sites=coll.top_sites())
    terms = {"compute_s": cost.flops / PEAK_FLOPS,
             "memory_s": cost.bytes / HBM_BW,
             "collective_s": collectives["total_bytes"] / NET_BW,
             "collective_wire_s": collectives["total_wire_bytes"] / NET_BW}
    art.update(
        ok=True, chips=chips, torch=torch.__version__,
        meta_s=round(meta_s, 2),
        trace_s=round(trace_s, 2),
        cost={"flops": total.flops, "bytes": total.bytes,
              "flops_per_device": cost.flops,
              "bytes_per_device": cost.bytes,
              "sites_per_device": cost.top_sites()},
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": cost.peak_bytes},
        collectives=collectives,
        per_device_bytes=per_device, roofline_terms=terms,
        dominant=max(("compute_s", "memory_s", "collective_s"),
                     key=lambda k: terms[k]),
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
    ap = argparse.ArgumentParser(
        description="multi-pod dry run on a virtual mesh")
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
                t, c = art["roofline_terms"], art["collectives"]
                print(f"  ok trace={art['trace_s']}s "
                      f"flops/dev={art['cost']['flops_per_device']:.3e} "
                      f"compute={t['compute_s']*1e3:.2f}ms "
                      f"memory={t['memory_s']*1e3:.2f}ms "
                      f"collective={t['collective_s']*1e3:.2f}ms "
                      f"dominant={art['dominant']}", flush=True)
                print("  collective bytes:", c["bytes"], "counts:",
                      c["counts"], flush=True)
                print("  memory:", art["memory"], flush=True)
                print("  bytes/device:", art["per_device_bytes"],
                      flush=True)
        else:
            n_fail += 1
            print(f"  FAIL: {art['error']}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
