"""The model zoo on the card against the port's CPU run at the same weights.

Marked ``cuda``; each test skips without a GPU.  The MoE layer (routing
exactly, output within ``TOL``), the Mamba scan and decode step (within
``TOL``), and the jamba smoke model (forward logits and aux, yes/no
engine logits and greedy streams) in float32, the card's run against the
CPU's; the jamba smoke model in bfloat16 under ``attn_impl="flash"``
launches K4 once a batch and K5 once a step for its attention layer.
No JAX is needed:

    python -m pytest tests/test_torch_model_zoo_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models import layers, lm
from repro_torch.models.config import LayerSpec
from repro_torch.serving import ServingEngine
from repro_torch.serving.batcher import BucketBatcher

TOL = 1e-4   # float32, the card against the CPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _layer(cfg, spec):
    return lm.init_layer(cfg, spec, torch.Generator().manual_seed(0),
                         torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_cuda_moe_matches_cpu(cuda, capacity_factor):
    cfg = smoke_config("jamba-v0.1-52b").replace(
        capacity_factor=capacity_factor)
    p = _layer(cfg, LayerSpec(ffn="moe"))["moe"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 32, cfg.d_model)).astype(np.float32))
    want = layers.moe_route(cfg, p, x)
    got = layers.moe_route(cfg, _to(p, cuda), x.to(cuda))
    assert got[3] == want[3]  # C
    for i in (2, 4, 5):  # topi, keep, dst
        assert torch.equal(got[i].cpu(), want[i])
    out, aux = layers.apply_moe(cfg, _to(p, cuda), x.to(cuda))
    ref, ref_aux = layers.apply_moe(cfg, p, x)
    torch.testing.assert_close(out.cpu(), ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("ssm_chunk,S", [(8, 20), (256, 64)])
def test_cuda_mamba_scan_and_decode_match_cpu(cuda, ssm_chunk, S):
    cfg = smoke_config("falcon-mamba-7b").replace(ssm_chunk=ssm_chunk)
    p = _layer(cfg, cfg.pattern[0])["mamba"]
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, S, cfg.d_model)).astype(np.float32))
    want = layers.mamba_scan(cfg, p, x)
    got = layers.mamba_scan(cfg, _to(p, cuda), x.to(cuda))
    for a, b in ((got[0], want[0]), (got[1][0], want[1][0]),
                 (got[1][1], want[1][1])):
        torch.testing.assert_close(a.cpu(), b, rtol=TOL, atol=TOL)
    state = {"h": want[1][0], "conv": want[1][1]}
    x1 = x[:, :1]
    ref, ref_state = layers.mamba_decode(cfg, p, x1, state)
    out, new_state = layers.mamba_decode(cfg, _to(p, cuda), x1.to(cuda),
                                         _to(state, cuda))
    torch.testing.assert_close(out.cpu(), ref, rtol=TOL, atol=TOL)
    for k in ("h", "conv"):
        torch.testing.assert_close(new_state[k].cpu(), ref_state[k],
                                   rtol=TOL, atol=TOL)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(8, 512, int(k)).tolist()
            for k in rng.integers(3, 45, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_cuda_jamba_smoke_matches_cpu(cuda, impl):
    cfg = smoke_config("jamba-v0.1-52b").replace(attn_impl=impl)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    on_card = _to(params, cuda)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)))
    ref, ref_aux = lm.forward(cfg, params, tokens)
    got, aux = lm.forward(cfg, on_card, tokens.to(cuda))
    torch.testing.assert_close(got.cpu(), ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-5, atol=0)
    prompts = _prompts(6)
    cpu_eng = ServingEngine(cfg, params, max_batch=4, device="cpu")
    card_eng = ServingEngine(cfg, on_card, max_batch=4, device=cuda)
    np.testing.assert_allclose(card_eng.first_token_logits(prompts, [3, 4]),
                               cpu_eng.first_token_logits(prompts, [3, 4]),
                               rtol=TOL, atol=TOL)
    assert card_eng.generate(prompts, max_new=6) == \
        cpu_eng.generate(prompts, max_new=6)


@pytest.mark.cuda
def test_cuda_jamba_smoke_bf16_runs_on_the_kernels(cuda):
    """One attention layer a superblock: K4 once a prefill batch and K5
    once a decode step for each superblock; the streams have the asked
    length and the logits are finite."""
    cfg = smoke_config("jamba-v0.1-52b").replace(attn_impl="flash",
                                                 dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    eng = ServingEngine(cfg, params, max_batch=4, device=cuda)
    prompts = _prompts(8, seed=3)
    batches = len(list(BucketBatcher(max_batch=4).plan(prompts)))
    k4, k5 = flash_attention_cuda.launches, decode_attention_cuda.launches
    streams = eng.generate(prompts, max_new=5)
    n_attn = cfg.n_superblocks
    assert flash_attention_cuda.launches - k4 == n_attn * batches
    assert decode_attention_cuda.launches - k5 == n_attn * batches * 5
    assert [len(s) for s in streams] == [5] * len(prompts)
    logits = eng.first_token_logits(prompts, [3, 4])
    assert np.isfinite(logits).all()
