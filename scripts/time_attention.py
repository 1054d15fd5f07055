#!/usr/bin/env python3
"""Time K4 (flash prefill), K5 (flash decoding) and a prefill batch of one
source tree of the port, on one NVIDIA GPU.

    python3 scripts/time_attention.py [ROOT]

ROOT is the root of a checkout (default: this one), so that two trees can
be compared in one process each on the same card, in turns (parent,
change, change, parent).  Printed, each beside the card's name and power
limit:

- K4 at one oracle batch of llama3.1-8b (B 64, H 32, KV 8, S 64, hd 128,
  bf16, causal) as the tree's wrapper takes it, and the model's whole
  attention core around it: the (B, S, heads, hd) projections in, the
  (B, S, H * hd) output out, with whatever copies the tree's wrapper
  needs (views where it takes strides);
- K5 at the generate shape (B 64, cache 128 slots as a permuted view,
  ragged lengths);
- a copy that moves as many bytes as K4 (reads half, writes half), as a
  yardstick of the rate the card reaches at that size;
- one prefill batch of a random-weight llama3.1-8b at full width and depth
  (64 prompts in the 64-token bucket through ServingEngine.
  first_token_logits): ms a batch (synchronised, unprofiled), and from
  torch.profiler the kernels' busy time, the device's idle share and the
  kernels that took the most time.

Kernel times are utils.timing.device_ms over four rotated input sets
(more bytes than the 50 MB L2 holds).  It needs a card.
"""
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
B, H, KV, S, HD, L_GEN, BATCHES = 64, 32, 8, 64, 128, 128, 5


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine
    from repro_torch.utils.timing import device_ms, monotonic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def projections():
        return [torch.randn((B, S, heads, HD), generator=g, device=dev)
                .to(torch.bfloat16) for heads in (H, KV, KV)]

    views = [tuple(t.transpose(1, 2) for t in projections())
             for _ in range(4)]
    try:
        flash_attention_cuda(*views[0])
        strided = True
    except ValueError:  # a tree whose K4 takes contiguous tensors only
        strided = False

    def as_taken(t):
        return t if strided else t.contiguous()

    def core(q, k, v):
        out = flash_attention_cuda(as_taken(q), as_taken(k), as_taken(v))
        return out.transpose(1, 2).reshape(B, S, -1)

    k4, _ = device_ms(flash_attention_cuda,
                      [tuple(as_taken(t) for t in s) for s in views])
    k4_core, _ = device_ms(core, views)
    del views

    def decode_inputs():
        q = torch.randn((B, H, HD), generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, L_GEN, KV, HD), generator=g, device=dev)
                .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
        lens = torch.randint(1, L_GEN + 1, (B,), generator=g, device=dev)
        lens[0], lens[-1] = 1, L_GEN
        return q, k, v, lens.to(torch.int32)

    k5, _ = device_ms(decode_attention_cuda,
                      [decode_inputs() for _ in range(4)])
    # a yardstick for K4's bytes: one copy that reads and writes as many
    # (84 MB at the record shape), rotated the same way
    half = (B * S * (H + 2 * KV) * HD + B * S * H * HD) // 2
    pairs = [(torch.empty(half, dtype=torch.bfloat16, device=dev),
              torch.randn(half, generator=g, device=dev).to(torch.bfloat16))
             for _ in range(4)]
    copy_ms, _ = device_ms(lambda dst, src: dst.copy_(src), pairs)
    del pairs
    print(f"tree {ROOT}  [{smi}]")
    print(f"K4 {k4:.4f} ms a call ({'strided views' if strided else 'contiguous'}"
          f"), {k4_core:.4f} ms with the model's copies or views around it; "
          f"K5 {k5:.4f} ms a call; a copy of K4's {4 * half / 1e6:.1f} MB "
          f"{copy_ms:.4f} ms ({4 * half / copy_ms / 1e9:.2f} TB/s)")

    cfg = get_config("llama3.1-8b").replace(attn_impl="flash")
    params = lm.init_params(cfg, g, device=dev)
    engine = ServingEngine(cfg, params, max_batch=B)
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(8, cfg.vocab_size, (S - 2,), generator=rng)
               .tolist() for _ in range(B)]
    ids = [5, 6]
    engine.first_token_logits(prompts, ids)
    torch.cuda.synchronize()
    t0 = monotonic()
    for _ in range(BATCHES):
        engine.first_token_logits(prompts, ids)
    torch.cuda.synchronize()
    wall_ms = (monotonic() - t0) * 1e3 / BATCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(BATCHES):
            engine.first_token_logits(prompts, ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / BATCHES
    print(f"prefill batch (B {B}, bucket {S}, {cfg.name} bf16 flash): wall "
          f"{wall_ms:.3f} ms (synchronised, unprofiled); kernels busy "
          f"{busy_ms:.3f} ms (profiled): idle share "
          f"{1 - busy_ms / wall_ms:.4f}; {len(kernels) / BATCHES:.0f} "
          f"launches a batch")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print("device time by kernel, a batch (ms, launches):")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {t / 1e3 / BATCHES:8.3f}  {n // BATCHES:5d}  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
