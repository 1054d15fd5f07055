"""Production training launcher: mesh + train loop + fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --steps 50 --ckpt-dir build/train

The flags and printed lines are the reference launcher's.  With
``--smoke`` it trains the reduced config of ``--arch`` on one card (a
local 1x1 mesh); without it the reference's production mesh of 256
(``--multi-pod``: 512) devices is required, and on fewer it raises as
the reference's does.  A full-width run on one card calls ``train_loop``
with the config and weights it builds (``chip_smoke.py`` phase 12).
Restart the same command after a crash: it resumes from the newest
committed checkpoint.

A checkpoint labelled ``step_N`` holds the state after N updates, the
step the resumed run starts from.  The reference saves its mid-run
checkpoints after the update of step N under the label N, so its resumed
run applies batch N a second time; here the mid-run save comes after the
update of step N - 1 under the same label, and a resumed run repeats no
batch (ROADMAP.md).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import HashTokenizer, PackedLoader, make_dataset
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.rules import MeshRules
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import OptConfig, adamw_init, make_train_step
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
               microbatches: int = 1, compression=None, mesh_shape=None):
    """Train ``params`` (on their device) for ``steps`` steps of
    ``loader.batch_at(step)``, AdamW at lr 3e-4 with 10 warmup steps over
    ``steps``, as the reference launcher.

    Resumes from the newest checkpoint in ``ckpt_dir`` when there is
    one (``params`` are then only its template), saves every
    ``ckpt_every`` steps on a thread and once more at the end.  Prints
    the reference's lines.  Returns (params, opt_state, history, mgr):
    ``history`` holds each step's metrics as device tensors, from the
    first step run.
    """
    oc = OptConfig(lr=3e-4, warmup_steps=10, total_steps=steps)
    step_fn = make_train_step(cfg, oc, microbatches=microbatches,
                              compression=compression)
    mgr = CheckpointManager(ckpt_dir, keep=3)
    device = tree_leaves(params)[0].device
    opt = adamw_init(params, oc)
    start = 0
    restored = mgr.restore({"params": params, "opt": opt})
    if restored[0] is not None:
        start, tree, _ = restored
        params, opt = tree["params"], tree["opt"]
        print(f"[train] resumed from step {start} "
              f"(re-sharded onto {dict(mesh_shape or {})})")

    batch_tokens = loader.batch * loader.seq
    history = []
    t0 = monotonic()
    for step in range(start, steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in loader.batch_at(step).items()}
        params, opt, m = step_fn(params, opt, batch)
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
    mesh = (make_local_mesh(1, 1, device=dev) if args.smoke
            else make_production_mesh(multi_pod=args.multi_pod, device=dev))
    loader = make_loader(cfg, args.batch, args.seq)
    with sharding_context(MeshRules(mesh)):
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        train_loop(cfg, params, loader, steps=args.steps,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   microbatches=args.microbatches,
                   compression=args.compression, mesh_shape=mesh.shape)
    print(f"[train] done; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
