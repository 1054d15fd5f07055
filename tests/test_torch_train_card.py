"""Training on the card against the port's CPU run at the same weights.

Marked ``cuda``; each test skips without a GPU.  The float32 smoke train
step of a dense, an MoE, a Mamba and a hybrid model: its metrics and
gradients within ``TOL`` of the CPU's, and the updated weights within
``TOL`` except for at most ``NOISE_SHARE`` of a leaf's entries, whose
gradients are float-order noise that Adam's normalisation turns into a
step of up to lr (``tests/test_torch_train.py``).  K4 and K5 refuse
gradients on the card, and the bf16 vocab product's hand-written
backward agrees with float32 autograd within bf16 rounding.  No JAX is
needed:

    python -m pytest tests/test_torch_train_card.py -m cuda
"""
import math

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train.trainer import _grads_of
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

TOL = 1e-4          # float32, the card against the CPU
NOISE_SHARE = 0.01  # entries of a leaf allowed past TOL after an update
LR = 3e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(cfg, seed=0, B=4, S=32):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _close(cpu, card, where, share=0.0):
    a = dict(tree_leaves_with_path(cpu))
    b = dict(tree_leaves_with_path(card))
    assert a.keys() == b.keys(), where
    for k in a:
        d = (a[k].float() - b[k].float().cpu()).abs()
        allowed = math.ceil(share * d.numel())
        assert int((d > TOL + TOL * a[k].float().abs()).sum()) <= allowed, (
            where, k, float(d.max()))
        assert float(d.max()) <= 4 * LR, (where, k, float(d.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    cfg = smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    oc = OptConfig(lr=LR, warmup_steps=2, total_steps=50)
    batch = _batch(cfg)
    on = lambda t: tree_map(lambda x: x.to(cuda), t)

    loss, metrics, grads = _grads_of(cfg, params, batch)
    c_loss, c_metrics, c_grads = _grads_of(cfg, on(params), on(batch))
    torch.testing.assert_close(c_loss.cpu(), loss, rtol=TOL, atol=TOL)
    for k in metrics:
        torch.testing.assert_close(c_metrics[k].cpu(), metrics[k], rtol=TOL,
                                   atol=TOL)
    _close(grads, c_grads, f"{arch} grads")

    step = make_train_step(cfg, oc)
    p, o, m = step(params, adamw_init(params, oc), batch)
    cp, co, cm = step(on(params), adamw_init(on(params), oc), on(batch))
    assert sorted(m) == sorted(cm)
    for k in m:
        torch.testing.assert_close(cm[k].cpu(), m[k], rtol=TOL, atol=TOL)
    _close(p, cp, f"{arch} params", NOISE_SHARE)
    _close(o["master"], co["master"], f"{arch} master", NOISE_SHARE)
    _close(o["mu"], co["mu"], f"{arch} mu")
    _close(o["nu"], co["nu"], f"{arch} nu")


@pytest.mark.cuda
def test_cuda_flash_under_gradients_raises(cuda):
    """attn_impl="flash" refuses a train step on the card; the kernels
    refuse inputs that require grad, and run without grad."""
    cfg = smoke_config("qwen1.5-0.5b").replace(attn_impl="flash")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    batch = tree_map(lambda t: t.to(cuda), _batch(cfg, S=128))
    before = flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="no backward"):
        _grads_of(cfg, params, batch)
    assert flash_attention_cuda.launches == before
    q = torch.randn((2, 4, 128, 16), device=cuda)
    k = torch.randn((2, 4, 128, 16), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q.requires_grad_(True), k, k)
    with torch.no_grad():
        flash_attention_cuda(q, k, k)
    qd = torch.randn((2, 4, 16), device=cuda, requires_grad=True)
    lens = torch.full((2,), 128, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_cuda(qd, k, k, lens)


@pytest.mark.cuda
def test_cuda_bf16_vocab_product_backward(cuda):
    """hidden_logits on a bf16 model: float32 logits from bf16 operands;
    the backward's products against float32 autograd of the same
    operands, within bf16 rounding of the cotangent."""
    cfg = smoke_config("qwen1.5-0.5b").replace(dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    table = params["embed"]["table"].detach().requires_grad_(True)
    h = torch.randn((4, 8, cfg.d_model), device=cuda).to(
        torch.bfloat16).requires_grad_(True)
    p = dict(params, embed={"table": table})
    logits = lm.hidden_logits(cfg, p, h)
    assert logits.dtype == torch.float32
    w = torch.randn_like(logits)
    gh, gt = torch.autograd.grad((logits * w).sum(), [h, table])
    assert gh.dtype == gt.dtype == torch.bfloat16

    hf = h.detach().float().requires_grad_(True)
    tf = table.detach().float().requires_grad_(True)
    ref = lm.hidden_logits(cfg.replace(dtype="float32"),
                           dict(params, embed={"table": tf}), hf)
    torch.testing.assert_close(logits, ref, rtol=2e-2, atol=2e-2)
    rh, rt = torch.autograd.grad((ref * w).sum(), [hf, tf])
    # a bf16 result is rounded at its own scale: half a bf16 step at the
    # largest entry is 2^-8 of it, so the absolute tolerance is ~2.5
    # such steps of the leaf's largest entry
    for got, want in ((gh, rh), (gt, rt)):
        torch.testing.assert_close(got.float(), want, rtol=3e-2,
                                   atol=1e-2 * float(want.abs().max()))
