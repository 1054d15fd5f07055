#!/usr/bin/env python3
"""Time the Mamba scan of one source tree of the port, on one NVIDIA GPU.

    python3 scripts/time_mamba_scan.py [ROOT]

ROOT is the root of a checkout (default: this one), so that two trees can
be compared in one process each on the same card, in turns (parent,
change, change, parent).  One jamba-v0.1-52b Mamba layer at published
widths (d_model 4,096, d_inner 8,192, ssm_state 16, bf16 weights from a
torch seed) runs ``layers.mamba_scan`` over the input of a phase-11
prefill batch (B 64, S 64) under ``inference_mode``: ms a call as device
time (``utils.timing.device_ms``, host ahead) and as synchronised wall
time (the median of 20 calls), printed beside the card's name and power
limit.  It needs a card.
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
B, S, CALLS = 64, 64, 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_mamba_scan: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import layers, lm
    from repro_torch.models.config import LayerSpec
    from repro_torch.utils.timing import device_ms, monotonic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config("jamba-v0.1-52b")
    g = torch.Generator(device=dev).manual_seed(0)
    p = lm.init_layer(cfg, LayerSpec(kind="mamba", ffn="none"), g,
                      dev)["mamba"]
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        run = lambda xi: layers.mamba_scan(cfg, p, xi)
        run(x)
        ms, ahead = device_ms(run, [(x,)])
        walls = []
        for _ in range(CALLS):
            torch.cuda.synchronize()
            t0 = monotonic()
            run(x)
            torch.cuda.synchronize()
            walls.append((monotonic() - t0) * 1e3)
    walls.sort()
    print(f"{ROOT}: mamba_scan at B {B}, S {S}, d_inner {cfg.d_inner}: "
          f"device {ms:.3f} ms a call (host ahead: {ahead}), wall median "
          f"{walls[len(walls) // 2]:.3f} ms [{walls[0]:.3f}-{walls[-1]:.3f}]"
          f"  [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
