#!/usr/bin/env python3
"""Where a decode step's time goes, on one NVIDIA GPU.

    python3 scripts/profile_decode.py

Builds the PyTorch port's llama3.1-8b at full width and depth with random
weights (bf16, attn_impl="flash"), prefills one batch of BATCH random
prompts of BUCKET tokens (the cache holds BUCKET + 64 slots, as
ServingEngine.generate sizes it), warms up, then traces STEPS decode
steps with torch.profiler.  The shape is chip_smoke.py's generate
phase: 64 prompts in the 64-token bucket.  It prints the host wall time of a step
(synchronised), the device time the kernels took, the device's idle share,
the kernel launches per step, and the kernels that took the most device
time, each beside the card's name and power limit.  It needs a card.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, BUCKET, STEPS = 64, 64, 5


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.utils.timing import monotonic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config("llama3.1-8b").replace(attn_impl="flash")
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, g, device=dev)
    B, S = BATCH, BUCKET
    tokens = torch.randint(8, cfg.vocab_size, (B, S), generator=g, device=dev)

    with torch.inference_mode():
        _, cache, pos = lm.prefill_hidden(cfg, params, tokens, max_len=S + 64)
        cur = tokens[:, -1]

        def step():
            nonlocal cache, pos, cur
            logits, cache = lm.decode_step(cfg, params, cache, cur, pos)
            pos, cur = pos + 1, torch.argmax(logits, dim=-1)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = monotonic()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (monotonic() - t0) * 1e3 / STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                step()
            torch.cuda.synchronize()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_ms = sum(e.time_range.elapsed_us()
                  for e in kernels) / 1e3 / STEPS
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3 / STEPS
    weights = sum(t.numel() * t.element_size() for sb in params["blocks"]
                  for layer in sb.values() for d in layer.values()
                  for t in d.values())
    weights += params["embed"]["table"].numel() * 2
    print(f"decode step, B {B}, cache {S + 64} slots, {cfg.name} bf16 "
          f"flash  [{smi}]")
    print(f"wall {wall_ms:.3f} ms a step (synchronised, unprofiled); "
          f"kernels busy {busy_ms:.3f} ms a step (profiled): idle share "
          f"{1 - busy_ms / wall_ms:.4f} of the unprofiled wall, "
          f"{1 - busy_ms / span_ms:.4f} of the profiled device span "
          f"({span_ms:.3f} ms)")
    print(f"{len(kernels) / STEPS:.0f} kernel launches a step; weights "
          f"{weights / 1e9:.2f} GB read a step, {weights / busy_ms / 1e6:.0f}"
          f" GB/s over the busy time")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print("device time by kernel, a step (ms, launches):")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, t) in top:
        print(f"  {t / 1e3 / STEPS:8.3f}  {n // STEPS:5d}  "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
