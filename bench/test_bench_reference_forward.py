"""The plain reference forward against the program's yes/no logits for
each configuration at smoke widths, float32, on the CPU, padded batches
at two buckets (MoE capacity counted at the padded length)."""
import pytest
import torch

from benchkit import spec, text
from repro_torch.models import lm


@pytest.mark.parametrize("workload", ["jamba.tc", "internvl2.tc"])
@pytest.mark.parametrize("T", [32, 64])
def test_reference_equals_program(smoke, workload, T):
    cs = smoke(workload)
    arch = spec.arch(cs["config"])
    d = arch.dims(cs["config"])
    mcfg = arch.program_config(cs["config"], d)
    params = arch.make_params(d, 3, torch.float32, "cpu")
    g = torch.Generator().manual_seed(T)
    lens = torch.randint(T // 2 + 1, T + 1, (6,), generator=g)
    toks = torch.zeros((6, T), dtype=torch.long)
    for b, n in enumerate(lens):
        toks[b, :n] = torch.randint(8, d["V"], (int(n),), generator=g)
    tid = torch.tensor([text.YES, text.NO])
    want = arch.yes_no_logits(d, params, arch.layer_list(params), toks,
                              lens, tid)
    got = lm.first_logits_select(mcfg, params, toks, lens,
                                 tid[None].expand(6, 2))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    low = arch.yes_no_logits(d, params, arch.layer_list(params), toks, lens,
                             tid, precision="fp8")
    assert (low - want).abs().max() > 100 * (got - want).abs().max()
