"""Production training launcher: mesh + train loop + fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --steps 50 --ckpt-dir build/train

The flags and printed lines are the reference launcher's.  With
``--smoke`` it trains the reduced config of ``--arch`` on one card, a
(data 1, model 1) layout with no process group behind it, so nothing is
partitioned; without it the reference's production mesh of 256
(``--multi-pod``: 512) ranks is required, and on fewer it raises as the
reference's does.  A full-width run on one card calls ``train_loop``
with the config and weights it builds (``chip_smoke.py`` phase 12).

``train_loop(..., mesh=)`` with a mesh over a process group
(``launch.mesh.make_local_mesh``) runs the partitioned program: the
parameters, the optimizer state and each batch are placed as DTensors
by their logical axes (``lm.param_logical_axes``,
``opt_logical_axes``, ``configs.input_logical_axes``), every rank runs
the same loop on its shards, and a restore re-shards the checkpoint
onto the mesh.  The reference builds its parameter shardings but never
hands them to ``jax.jit``, so its launcher places nothing (ROADMAP.md);
here the parameters are placed as its dry run places them.  Restart the
same command after a crash: it resumes from the newest committed
checkpoint, on any mesh.

A checkpoint labelled ``step_N`` holds the state after N updates, the
step the resumed run starts from.  The reference saves its mid-run
checkpoints after the update of step N under the label N, so its resumed
run applies batch N a second time; here the mid-run save comes after the
update of step N - 1 under the same label, and a resumed run repeats no
batch (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import contextlib

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, input_logical_axes, smoke_config
from repro_torch.data import HashTokenizer, PackedLoader, make_dataset
from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                         sharding_context, tree_placements)
from repro_torch.distributed.rules import MeshRules
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import opt_logical_axes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import monotonic
from repro_torch.utils.tree import tree_leaves


def make_loader(cfg: ModelConfig, batch: int, seq: int) -> PackedLoader:
    """The launcher's data: 2,000 imdb_review texts through the hash
    tokenizer, packed into (batch, seq) token and target rows."""
    tok = HashTokenizer(cfg.vocab_size)
    ds = make_dataset("imdb_review", n=2000, seed=0)
    return PackedLoader([tok.encode(t) for t in ds.texts], batch=batch,
                        seq=seq, seed=0)


def train_loop(cfg: ModelConfig, params, loader: PackedLoader, *,
               steps: int, ckpt_dir: str, ckpt_every: int = 25,
               microbatches: int = 1, compression=None, mesh=None):
    """Train ``params`` (on their device) for ``steps`` steps of
    ``loader.batch_at(step)``, AdamW at lr 3e-4 with 10 warmup steps over
    ``steps``, as the reference launcher.

    Resumes from the newest checkpoint in ``ckpt_dir`` when there is
    one (``params`` are then only its template), saves every
    ``ckpt_every`` steps on a thread and once more at the end.  Prints
    the reference's lines.  Returns (params, opt_state, history, mgr):
    ``history`` holds each step's metrics as whole device tensors, from
    the first step run.

    ``mesh``: a ``launch.mesh.Mesh``.  With a ``DeviceMesh`` behind it,
    the loop runs the partitioned program (every rank calls it with the
    same ``params``) and returns DTensor parameters and state; a
    layout-only mesh, or None, gives the unpartitioned loop.
    """
    oc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=steps)
    step_fn = make_train_step(cfg, oc, microbatches=microbatches,
                              compression=compression)
    mgr = CheckpointManager(ckpt_dir, keep=3)
    device = tree_leaves(params)[0].device
    opt = adamw_init(params, oc)
    place = lambda batch: batch  # noqa: E731
    shardings, context = None, contextlib.nullcontext
    if mesh is not None and mesh.device_mesh is not None:
        rules = MeshRules(mesh)
        context = lambda: sharding_context(rules)  # noqa: E731
        axes = {"params": lm.param_logical_axes(cfg)}
        axes["opt"] = opt_logical_axes(axes["params"], oc)
        state = distribute_tree({"params": params, "opt": opt}, axes, rules)
        params, opt = state["params"], state["opt"]
        shardings = tree_placements(state, axes, rules)
        place = lambda batch: distribute_tree(  # noqa: E731
            batch, input_logical_axes(batch), rules)
    start = 0
    restored = mgr.restore({"params": params, "opt": opt}, shardings)
    if restored[0] is not None:
        start, tree, _ = restored
        params, opt = tree["params"], tree["opt"]
        print(f"[train] resumed from step {start} "
              f"(re-sharded onto {dict(mesh.shape) if mesh else {}})")

    batch_tokens = loader.batch * loader.seq
    history = []
    t0 = monotonic()
    for step in range(start, steps):
        batch = place({k: torch.from_numpy(v).to(device)
                       for k, v in loader.batch_at(step).items()})
        with context():
            params, opt, m = step_fn(params, opt, batch)
        m = gather_tree(m)
        history.append(m)
        if step % 10 == 0 or step == steps - 1:
            tput = batch_tokens * max(1, step - start + 1) / (
                monotonic() - t0)
            print(f"[train] step {step:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} tok/s={tput:,.0f}",
                  flush=True)
        if step + 1 < steps and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt}, async_=True)
    mgr.wait()
    mgr.save(steps, {"params": params, "opt": opt})
    return params, opt, history, mgr


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = (Mesh(("data", "model"), (1, 1)) if args.smoke
            else make_production_mesh(multi_pod=args.multi_pod, device=dev))
    loader = make_loader(cfg, args.batch, args.seq)
    with sharding_context(MeshRules(mesh)):
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        train_loop(cfg, params, loader, steps=args.steps,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   microbatches=args.microbatches,
                   compression=args.compression, mesh=mesh)
    print(f"[train] done; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
