"""End-to-end training example: train a ~100M-param qwen-family model for a
few hundred steps on synthetic text with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.examples.train_backbone \\
        [--steps 300] [--size 100m] [--ckpt-dir build/train_backbone]

Random weights from a torch seed, float32, on the card
(``main(argv, device="cpu")`` for the CPU).  Rerun the same command after
a crash: it restores the newest checkpoint and carries on.  A fresh run
of five steps or more asserts that the loss falls.
"""
import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_dataset
from repro_torch.data.loader import PackedLoader
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import monotonic


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", default="100m", choices=["tiny", "100m"])
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    base = get_config("qwen1.5-0.5b")
    if args.size == "100m":
        cfg = base.replace(n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
                           d_ff=2048, vocab_size=32768, dtype="float32")
    else:
        cfg = base.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                           d_ff=256, vocab_size=4096, dtype="float32")
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    tok = HashTokenizer(cfg.vocab_size)
    ds = make_dataset("imdb_review", n=3000, seed=0)
    docs = [tok.encode(t) for t in ds.texts]
    B, S = (8, 128) if args.size == "100m" else (4, 64)
    loader = PackedLoader(docs, batch=B, seq=S, seed=0)

    oc = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, oc)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    opt = adamw_init(params, oc)
    start = 0
    restored = mgr.restore({"params": params, "opt": opt})
    if restored[0] is not None:
        start, tree, _ = restored
        params, opt = tree["params"], tree["opt"]
        print(f"restored from checkpoint @ step {start}")

    losses = []
    t0 = monotonic()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in loader.batch_at(step).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(m["loss"])
        if step % 20 == 0 or step == args.steps - 1:
            tput = B * S * (step - start + 1) / (monotonic() - t0)
            print(f"step {step:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} "
                  f"lr={float(m['lr']):.2e} tok/s={tput:,.0f}")
        if step + 1 < args.steps and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt}, async_=True)
    mgr.wait()
    mgr.save(args.steps, {"params": params, "opt": opt})
    if start == 0 and len(losses) >= 5:  # a fresh run of a few steps
        first, last = float(losses[0]), float(losses[-1])
        assert last < first, f"the loss did not fall: {first} -> {last}"
    print(f"done; checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
