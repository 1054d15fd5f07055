"""K4 (flash attention) at its roofline, in %: the least time of every
launch the window made (the larger of its bytes over the HBM rate and
its FLOPs over the bfloat16 peak, from each ``engine_tick``'s batch and
bucket and the configuration's heads, one launch an attention layer)
over K4's device time by kernel name."""
from benchkit.devtrace import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from benchkit.flops import k4_launch

KERNELS = r"flash_tc_kernel|flash_fwd_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.kernel_seconds(KERNELS)
    if device_s <= 0:
        return None
    d = ctx.d
    n_attn = sum(m == "attn" for m, _ in d["layers"])
    least = 0.0
    for t in (s for s in ctx.spans if s.name == "engine_tick"):
        flops, nbytes = k4_launch(t.attrs["batch"], t.attrs["bucket_len"],
                                  d["H"], d["KV"], d["hd"])
        least += n_attn * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * least / device_s
