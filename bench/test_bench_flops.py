"""The benchmark's FLOP count against ``launch.op_cost``'s count of the
same smoke prefill: in its ``executed`` form (every padded position, the
whole score square, every MoE capacity slot, Mamba's one scan product:
what op_cost's matmul-class operations see) the two agree; the useful
count the ``mfu`` metric uses is below it by what padding, the causal
half, empty capacity slots and the vocabulary-free head leave out."""
import pytest
import torch

from benchkit import flops, spec
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import lm


@pytest.mark.parametrize("workload", ["jamba.tc", "internvl2.tc"])
@pytest.mark.parametrize("T", [32, 64])
def test_count_equals_op_cost(smoke, workload, T):
    cs = smoke(workload)
    arch = spec.arch(cs["config"])
    d = arch.dims(cs["config"])
    mcfg = arch.program_config(cs["config"], d).replace(attn_impl="plain")
    params = arch.make_params(d, 1, torch.float32, "cpu")
    B = 5
    lens = torch.full((B,), T)
    toks = torch.randint(8, d["V"], (B, T))
    with torch.no_grad(), OpCost() as cost:
        lm.first_logits_select(mcfg, params, toks, lens,
                               torch.tensor([[3, 4]] * B))
    ours = arch.prefill_flops(d, [T] * B, T=T, executed=True)
    assert abs(ours - cost.flops) <= 1e-3 * cost.flops
    useful = arch.prefill_flops(d, [T // 2] * B)
    assert 0 < useful < ours


def test_k4_launch_counts():
    f, b = flops.k4_launch(64, 32, 32, 8, 128)
    assert f == 4 * 64 * 32 * 128 * (32 * 33 // 2)
    assert b == 2 * 64 * 32 * 128 * (2 * 32 + 2 * 8)
