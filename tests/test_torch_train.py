"""The port's training against the JAX reference, on the CPU.

Both packages start from the reference's ``init_params`` tree (carried
into the port by ``lm.params_from_jax``) and take the same numpy
batches.  One and three train steps on the smoke configs of the six
families (dense, MoE, Mamba, hybrid, encoder-decoder, VLM prefix), with
microbatches and gradient compression, and a reference state after three
steps (carried by ``opt_state_from_jax``) continued for three more:

- the metrics (loss, ce, aux, grad_norm, lr) within ``METRIC_RTOL`` at the
  first step, ``METRIC_RTOL_LATER`` after it;
- mu and nu within ``MOMENT_ATOL``;
- params and master within ``PARAM_ATOL``, except for at most
  ``NOISE_SHARE`` of a leaf's entries (rounded up), which must stay within
  ``2 * lr * steps``.  Adam divides each gradient by its own scale, so an
  entry whose gradient is float-order noise (a sum that cancels to ~1e-9)
  moves by up to lr in a direction that noise picks, in either package;
  a systematic fault (decay, bias correction, clipping, rounding) moves
  every entry and fails the 1e-5.  (The key bias's gradient is such
  noise throughout: a bias added to every key shifts all of a query's
  scores alike.)  ``adamw_update`` alone, on the same
  gradients, is held to ``EXACT_ATOL``.

Also: every case of ``tests/test_train_ckpt.py`` on the port; ``lr_at``
for each schedule; the K4 guard (``attn_impl="flash"`` under gradients
raises in both packages, "flash-ref" trains); gradients through the
Mamba scan within ``GRAD_TOL``; ``launch.train.main`` against the
reference's, and the reference's mid-run checkpoint, whose resume
applies one batch twice (ROADMAP.md), against the port's.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.train import OptConfig as JOptConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import lr_at as jlr_at
from repro.train.trainer import loss_fn as jloss_fn
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)
from repro_torch.configs import smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train.grad_compression import (_int8_roundtrip,
                                                compress_with_feedback)
from repro_torch.train.optimizer import (adamw_update, lr_at,
                                         opt_state_from_jax)
from repro_torch.train.trainer import _grads_of
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

METRIC_RTOL = 1e-5        # the first step's metrics, float32
METRIC_RTOL_LATER = 5e-5  # later steps' (their params carry Adam's noise)
MOMENT_ATOL = 1e-5        # mu, nu
PARAM_ATOL = 1e-5         # params, master (all but NOISE_SHARE of a leaf)
NOISE_SHARE = 0.01        # entries of a leaf allowed past PARAM_ATOL
# under int8 compression: g/scale within float noise of a half-integer
# rounds to either neighbour, one quantum (max|g|/127) apart, in either
# package, and Adam's step then differs in that entry
NOISE_SHARE_INT8 = 0.05
EXACT_ATOL = 1e-6         # adamw_update alone, on the same gradients
GRAD_TOL = 1e-4           # gradients through the Mamba scan
LR = 3e-3                 # tests/test_train_ckpt.py's _setup
FAMILIES = ["qwen1.5-0.5b", "mixtral-8x22b", "falcon-mamba-7b",
            "jamba-v0.1-52b", "whisper-base", "internvl2-26b"]


def _oc(pkg, lr=LR):
    return (JOptConfig if pkg == "jax" else OptConfig)(
        lr=lr, warmup_steps=2, total_steps=50)


def _ref_tree(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jlm.init_params(cfg, jax.random.key(seed)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(jcfg, n, B=4, S=16, seed=0):
    """n numpy batches: tokens/targets and the family's modality stub."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if jcfg.num_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (B, jcfg.num_prefix_embeds, jcfg.d_model)).astype(np.float32)
        if jcfg.is_encdec:
            b["enc_frames"] = rng.standard_normal(
                (B, jcfg.encoder_len, jcfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_metrics(jm, tm, rtol, where):
    assert sorted(jm) == sorted(tm), (where, sorted(jm), sorted(tm))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   atol=1e-7, err_msg=f"{where}: {k}")


def _assert_adam_close(ref, got, bound, where, share=NOISE_SHARE,
                       atol=PARAM_ATOL):
    """Within ``atol`` on all but ``share`` of each leaf's entries (rounded
    up), every entry within ``bound`` (see the module docstring)."""
    a, b = dict(tree_leaves_with_path(ref)), dict(tree_leaves_with_path(got))
    assert a.keys() == b.keys(), where
    for k in a:
        d = (a[k].float() - b[k].float()).abs()
        n_out = int((d > atol).sum())
        assert n_out <= math.ceil(share * d.numel()), (
            where, k, n_out, d.numel(), float(d.max()))
        assert float(d.max()) <= bound, (where, k, float(d.max()))


def _assert_tree_close(ref, got, atol, where):
    a, b = dict(tree_leaves_with_path(ref)), dict(tree_leaves_with_path(got))
    assert a.keys() == b.keys(), where
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        np.testing.assert_allclose(b[k].float().numpy(), a[k].float().numpy(),
                                   rtol=0, atol=atol, err_msg=f"{where}: {k}")


def _assert_states(tcfg, jp, jo, tp, to, lr, steps, where,
                   share=NOISE_SHARE):
    ref_p = lm.params_from_jax(tcfg, _np(jp), device="cpu")
    ref_o = opt_state_from_jax(tcfg, _np(jo), device="cpu")
    assert int(to["step"]) == int(ref_o["step"]) == steps, where
    _assert_adam_close(ref_p, tp, 2 * lr * steps, where + " params", share)
    _assert_adam_close(ref_o["master"], to["master"], 2 * lr * steps,
                       where + " master", share)
    for k in ("mu", "nu"):
        if share == NOISE_SHARE:
            _assert_tree_close(ref_o[k], to[k], MOMENT_ATOL, f"{where} {k}")
        else:  # int8: a moment takes (1 - b) of a gradient one quantum off
            _assert_adam_close(ref_o[k], to[k], 1e-3, f"{where} {k}", share,
                               MOMENT_ATOL)


def _run_both(arch, batches, microbatches=1, compression=None, jstate=None):
    """The same steps on both packages from the same tree (or from a
    reference (params, opt) state); returns both states and metrics."""
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    joc, toc = _oc("jax"), _oc("torch")
    if jstate is None:
        tree = _ref_tree(jcfg)
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jo = jadamw_init(jp, joc)
    else:
        jp, jo = jstate
    tp = lm.params_from_jax(tcfg, _np(jp), device="cpu")
    to = opt_state_from_jax(tcfg, _np(jo), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, joc, microbatches, compression))
    tstep = make_train_step(tcfg, toc, microbatches, compression)
    metrics = []
    for b in batches:
        jp, jo, jm = jstep(jp, jo, _j(b))
        tp, to, tm = tstep(tp, to, _t(b))
        metrics.append((jm, tm))
    return tcfg, (jp, jo), (tp, to), metrics


# --------------------------------------------------- one and three steps


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_and_three_steps_equal_the_reference(arch):
    batches = _batches(jsmoke(arch), 3)
    tcfg, (jp, jo), (tp, to), metrics = _run_both(arch, batches[:1])
    _assert_metrics(*metrics[0], METRIC_RTOL, f"{arch} step 0")
    _assert_states(tcfg, jp, jo, tp, to, LR, 1, f"{arch} 1 step")

    tcfg, (jp, jo), (tp, to), metrics = _run_both(arch, batches)
    for i, (jm, tm) in enumerate(metrics):
        _assert_metrics(jm, tm, METRIC_RTOL if i == 0 else METRIC_RTOL_LATER,
                        f"{arch} step {i}")
    _assert_states(tcfg, jp, jo, tp, to, LR, 3, f"{arch} 3 steps")


@pytest.mark.parametrize("microbatches,compression",
                         [(2, None), (1, "int8"), (1, "topk"), (2, "int8")])
def test_microbatches_and_compression_equal_the_reference(microbatches,
                                                          compression):
    arch = "qwen1.5-0.5b"
    tcfg, (jp, jo), (tp, to), metrics = _run_both(
        arch, _batches(jsmoke(arch), 3), microbatches, compression)
    for i, (jm, tm) in enumerate(metrics):
        _assert_metrics(jm, tm, METRIC_RTOL if i == 0 else METRIC_RTOL_LATER,
                        f"step {i}")
    if microbatches > 1:  # the reference's microbatched metrics
        assert sorted(metrics[0][1]) == ["grad_norm", "loss", "lr"]
    _assert_states(tcfg, jp, jo, tp, to, LR, 3,
                   f"microbatches {microbatches}, {compression}",
                   NOISE_SHARE_INT8 if compression == "int8" else NOISE_SHARE)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x22b"])
def test_reference_state_after_three_steps_continues_to_six(arch):
    jcfg = jsmoke(arch)
    batches = _batches(jcfg, 6)
    joc = _oc("jax")
    jp = jax.tree_util.tree_map(jnp.asarray, _ref_tree(jcfg))
    jo = jadamw_init(jp, joc)
    jstep = jax.jit(jmake_train_step(jcfg, joc))
    for b in batches[:3]:
        jp, jo, _ = jstep(jp, jo, _j(b))
    tcfg, (jp, jo), (tp, to), metrics = _run_both(arch, batches[3:],
                                                  jstate=(jp, jo))
    for i, (jm, tm) in enumerate(metrics):
        _assert_metrics(jm, tm, METRIC_RTOL if i == 0 else METRIC_RTOL_LATER,
                        f"step {3 + i}")
    _assert_states(tcfg, jp, jo, tp, to, LR, 6, f"{arch} 3 -> 6")


def test_adamw_update_alone_equals_the_reference():
    """The optimizer on identical gradients: clipping (the norm is above
    1), bias correction, decay on every leaf, bf16 rounding."""
    arch = "qwen1.5-0.5b"
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    tree = _ref_tree(jcfg)
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(a.dtype), tree)
    for dtype in ("float32", "bfloat16"):
        jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), grads)
        tcfg_d = tcfg.replace(dtype=dtype)
        tp = lm.params_from_jax(tcfg_d, _np(jt), device="cpu")
        tg = lm.params_from_jax(tcfg_d, _np(jg), device="cpu")
        for keep_master in (True, False):
            joc = JOptConfig(lr=LR, warmup_steps=2, total_steps=50,
                             keep_master=keep_master)
            toc = OptConfig(lr=LR, warmup_steps=2, total_steps=50,
                            keep_master=keep_master)
            jo, to = jadamw_init(jt, joc), adamw_init(tp, toc)
            jp2, to2_ref, jm = jt, jo, None
            tp2, to2 = tp, to
            for _ in range(3):
                jp2, to2_ref, jm = jadamw_update(jp2, jg, to2_ref, joc)
                tp2, to2, tm = adamw_update(tp2, tg, to2, toc)
                # the norm sums stacked leaves in the reference, one
                # superblock at a time here: float order only
                _assert_metrics(jm, tm, METRIC_RTOL, f"{dtype} {keep_master}")
            ref_p = lm.params_from_jax(tcfg_d, _np(jp2), device="cpu")
            _assert_tree_close(ref_p, tp2,
                               EXACT_ATOL if dtype == "float32" else 0,
                               f"{dtype} keep_master={keep_master} params")
            ref_o = opt_state_from_jax(tcfg_d, _np(to2_ref), device="cpu")
            assert sorted(ref_o) == sorted(to2)
            for k in ("mu", "nu", "master"):
                if k in ref_o:
                    _assert_tree_close(ref_o[k], to2[k], EXACT_ATOL,
                                       f"{dtype} {k}")


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_each_schedule(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    joc, toc = JOptConfig(**kw), OptConfig(**kw)
    for step in range(0, 45):
        want = float(jlr_at(joc, jnp.int32(step)))
        np.testing.assert_allclose(float(lr_at(toc, step)), want, rtol=1e-6)
        np.testing.assert_allclose(
            float(lr_at(toc, torch.tensor(step, dtype=torch.int32))), want,
            rtol=1e-6)


# ------------------------------- tests/test_train_ckpt.py, on the port


def _setup(arch="qwen1.5-0.5b", lr=3e-3):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    params = lm.params_from_jax(cfg, _ref_tree(jcfg), device="cpu")
    oc = OptConfig(lr=lr, warmup_steps=2, total_steps=50)
    return cfg, params, oc, adamw_init(params, oc)


def _batch(cfg, B=4, S=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_loss_decreases():
    cfg, params, oc, opt = _setup()
    step = make_train_step(cfg, oc)
    batch = _batch(cfg)
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_microbatched_grads_match_full():
    cfg, params, oc, opt = _setup()
    batch = _batch(cfg, B=4)
    p1, _, m1 = make_train_step(cfg, oc)(params, opt, batch)
    p2, _, m2 = make_train_step(cfg, oc, microbatches=2)(params, opt, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    l1, l2 = tree_leaves(p1)[3], tree_leaves(p2)[3]
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-3, atol=1e-5)


def test_int8_roundtrip_error_small():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256,))
                         .astype(np.float32))
    r = _int8_roundtrip(g)
    assert float(torch.linalg.norm(r - g) / torch.linalg.norm(g)) < 0.02


def test_error_feedback_contracts():
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(rng.normal(size=(128,)).astype(np.float32))
              for _ in range(30)]
    res = {"w": torch.zeros(128)}
    sent_sum, true_sum = torch.zeros(128), torch.zeros(128)
    for g in g_true:
        comp, res = compress_with_feedback({"w": g}, res, method="topk",
                                           topk_frac=0.2)
        sent_sum = sent_sum + comp["w"]
        true_sum = true_sum + g
    gap = float(torch.linalg.norm(sent_sum - true_sum))
    assert gap == pytest.approx(float(torch.linalg.norm(res["w"])), rel=1e-4)
    assert gap < 0.5 * float(torch.linalg.norm(true_sum))


def test_checkpoint_roundtrip(tmp_path):
    cfg, params, oc, opt = _setup()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(3, {"params": params, "opt": opt}, {"note": "x"})
    step, tree, extra = mgr.restore({"params": params, "opt": opt})
    assert step == 3 and extra["note"] == "x"
    for a, b in zip(tree_leaves(tree["params"]), tree_leaves(params)):
        assert torch.equal(a, b)
    assert tree["opt"]["step"].dtype == torch.int32
    assert mgr.saves[0]["step"] == 3 and mgr.saves[0]["bytes"] > 0


def test_checkpoint_gc_and_crash_cleanup(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    (tmp_path / "step_00000005.tmp-dead").mkdir()  # a crashed writer
    assert mgr.latest_step() == 4
    mgr.save(6, tree)
    assert not list(tmp_path.glob("*.tmp-*"))


def test_checkpoint_detects_corruption(tmp_path):
    save_pytree({"x": torch.arange(16)}, tmp_path / "ck")
    blob, = (tmp_path / "ck").glob("shard_000.msgpack.*")
    data = bytearray(blob.read_bytes())
    data[-1] ^= 0xFF
    blob.write_bytes(bytes(data))
    with pytest.raises(Exception):
        load_pytree(tmp_path / "ck", {"x": torch.arange(16)})


def test_async_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(100)}, async_=True)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_train_resume_equivalence(tmp_path):
    """Crash/restart: resume from checkpoint reproduces the exact state."""
    cfg, params, oc, opt = _setup()
    step = make_train_step(cfg, oc)
    mgr = CheckpointManager(tmp_path)
    b = [_batch(cfg, seed=s) for s in range(6)]
    for i in range(3):
        params, opt, _ = step(params, opt, b[i])
    mgr.save(3, {"params": params, "opt": opt})
    cont_p, cont_o = params, opt
    for i in range(3, 6):
        cont_p, cont_o, _ = step(cont_p, cont_o, b[i])
    _, tree, _ = mgr.restore({"params": params, "opt": opt})
    res_p, res_o = tree["params"], tree["opt"]
    for i in range(3, 6):
        res_p, res_o, _ = step(res_p, res_o, b[i])
    for a, c in zip(tree_leaves(res_p), tree_leaves(cont_p)):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   atol=1e-6)


# ------------------------------------------------------- the two repairs


def test_flash_under_gradients_raises_in_both_packages():
    """The reference's Pallas kernel has no JVP rule; the port's K4 has no
    backward and refuses, on the CPU's plain route too.  "flash-ref"
    trains in both and gives "auto"'s loss."""
    arch = "qwen1.5-0.5b"
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    tree = _ref_tree(jcfg)
    b = _batches(jcfg, 1, B=2, S=128)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = lm.params_from_jax(tcfg, tree, device="cpu")
    with pytest.raises(AssertionError):
        jax.grad(lambda p: jloss_fn(jcfg.replace(attn_impl="flash"), p,
                                    _j(b))[0])(jp)
    with pytest.raises(RuntimeError, match="no backward"):
        _grads_of(tcfg.replace(attn_impl="flash"), tp, _t(b))
    with torch.no_grad():  # the forward alone runs, as the reference's
        lm.forward(tcfg.replace(attn_impl="flash"), tp, _t(b)["tokens"])
    auto, _, _ = _grads_of(tcfg, tp, _t(b))
    ref, _, _ = _grads_of(tcfg.replace(attn_impl="flash-ref"), tp, _t(b))
    want = float(jax.value_and_grad(lambda p: jloss_fn(
        jcfg.replace(attn_impl="flash-ref"), p, _j(b))[0])(jp)[0])
    np.testing.assert_allclose(float(ref), want, rtol=METRIC_RTOL)
    np.testing.assert_allclose(float(auto), want, rtol=METRIC_RTOL)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_gradients_through_the_mamba_scan(arch):
    """Backward through ``mamba_scan`` (the chunk recurrence, its carry
    and the inner remat) equals jax.grad of the reference's scan."""
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    tree = _ref_tree(jcfg)
    b = _batches(jcfg, 1, B=2, S=40)[0]   # 40: two chunks of 16 and a tail
    jg = jax.grad(lambda p: jloss_fn(jcfg, p, _j(b))[0])(
        jax.tree_util.tree_map(jnp.asarray, tree))
    _, _, tg = _grads_of(tcfg, lm.params_from_jax(tcfg, tree, device="cpu"),
                         _t(b))
    want = dict(tree_leaves_with_path(
        lm.params_from_jax(tcfg, _np(jg), device="cpu")))
    got = dict(tree_leaves_with_path(tg))
    assert want.keys() == got.keys()
    assert any("mamba" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


# --------------------------------------------------------- the launcher


def _auto_local_mesh(n_data=1, n_model=1):
    """The reference's local mesh with Auto axes.  Its launcher calls
    ``with_sharding_constraint`` inside the mesh, which JAX 0.9 refuses
    on the Explicit axes ``jax.make_mesh`` now gives by default (the
    pinned 0.4.37 gave Auto); ROADMAP.md queue 3."""
    return jax.make_mesh((n_data, n_model), ("data", "model"),
                         devices=jax.devices()[:n_data * n_model],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _run_ref(argv, monkeypatch, capsys):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["prog"] + list(argv))
    monkeypatch.setattr(jtrain, "make_local_mesh", _auto_local_mesh)
    jtrain.main()
    return capsys.readouterr().out


def _run_port(argv, capsys):
    capsys.readouterr()
    ttrain.main(list(argv), device="cpu")
    return capsys.readouterr().out


def _loss_lines(out):
    """(step, loss, gnorm) of each "[train] step" line, and the rest
    without the tok/s."""
    rows, rest = [], []
    for line in out.splitlines():
        if line.startswith("[train] step"):
            f = line.split()
            rows.append((int(f[2]), float(f[3].split("=")[1]),
                         float(f[4].split("=")[1])))
        else:
            rest.append(line.replace(str(line.split(" ")[-1]), "")
                        if "checkpoints in" in line else line)
    return rows, rest


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's launcher draws the reference's init_params(key 0)."""
    monkeypatch.setattr(lm, "init_params", lambda cfg, gen, device: (
        lm.params_from_jax(cfg, _ref_tree(jsmoke(cfg.name)), device=device)))


def _assert_lines(ref_out, port_out):
    (jr, jrest), (tr, trest) = _loss_lines(ref_out), _loss_lines(port_out)
    assert [r[0] for r in tr] == [r[0] for r in jr], (ref_out, port_out)
    for (_, jl, jg), (_, tl, tg) in zip(jr, tr):
        assert abs(tl - jl) <= 1e-4 + 5e-5, (ref_out, port_out)  # 4 places
        assert abs(tg - jg) <= 1e-2 + 5e-3, (ref_out, port_out)  # 2 places
    assert trest == jrest, (ref_out, port_out)


def test_train_main_equals_the_reference_and_resumes(tmp_path, monkeypatch,
                                                     capsys,
                                                     reference_weights):
    common = ["--smoke", "--batch", "2", "--seq", "32", "--ckpt-every", "5"]
    runs = {}
    for pkg, run in (("jax", lambda a: _run_ref(a, monkeypatch, capsys)),
                     ("torch", lambda a: _run_port(a, capsys))):
        d = str(tmp_path / pkg)
        runs[pkg] = [run(common + ["--steps", "12", "--ckpt-dir", d]),
                     run(common + ["--steps", "14", "--ckpt-dir", d])]
    for ref_out, port_out in zip(runs["jax"], runs["torch"]):
        _assert_lines(ref_out.replace(str(tmp_path / "jax"), "DIR"),
                      port_out.replace(str(tmp_path / "torch"), "DIR"))
    assert "[train] resumed from step 12 (re-sharded onto {'data': 1, " \
           "'model': 1})" in runs["torch"][1]
    assert sorted(p.name for p in (tmp_path / "torch").glob("step_*")) == \
        sorted(p.name for p in (tmp_path / "jax").glob("step_*"))


def test_resume_from_a_mid_run_checkpoint_repeats_no_batch(
        tmp_path, monkeypatch, capsys, reference_weights):
    """A run killed after its step-10 checkpoint (its final one moved
    away) and resumed.  The port's resumed run ends on the unkilled run's
    state: 12 updates, the same weights.  The reference's step-10
    checkpoint holds 11 updates, so its resumed run applies batch 10 a
    second time and ends on 13."""
    from repro.checkpoint import load_pytree as jload_pytree
    common = ["--smoke", "--batch", "2", "--seq", "32", "--ckpt-every", "5",
              "--steps", "12"]
    ends = {}
    for pkg, run in (("jax", lambda a: _run_ref(a, monkeypatch, capsys)),
                     ("torch", lambda a: _run_port(a, capsys))):
        d = tmp_path / pkg
        run(common + ["--ckpt-dir", str(d)])
        (d / "step_00000012").rename(tmp_path / f"{pkg}_unkilled")
        _, rest = _loss_lines(run(common + ["--ckpt-dir", str(d)]))
        assert any("resumed from step 10" in line for line in rest), rest
        ends[pkg] = [jload_pytree(p)[0] for p in
                     (tmp_path / f"{pkg}_unkilled", d / "step_00000012")]
    (t_unkilled, t_resumed), (j_unkilled, j_resumed) = ends["torch"], \
        ends["jax"]
    assert int(t_unkilled["opt/step"]) == int(t_resumed["opt/step"]) == 12
    assert t_unkilled.keys() == t_resumed.keys()
    for k in t_unkilled:
        np.testing.assert_array_equal(t_resumed[k], t_unkilled[k], err_msg=k)
    assert int(j_unkilled["opt/step"]) == 12
    assert int(j_resumed["opt/step"]) == 13


def test_train_main_refuses_cuda_without_a_card_and_a_small_mesh(
        monkeypatch, tmp_path):
    """On the card unless the caller asks for the CPU; without --smoke
    the production mesh's 256 devices, as the reference's launcher."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="need 256 devices"):
        ttrain.main(["--ckpt-dir", str(tmp_path)], device="cpu")
    assert not list(tmp_path.glob("step_*"))


def test_recurrence_backward_is_the_derivative():
    """The Mamba scan's in-place recurrence against finite differences in
    float64 (its backward is written by hand)."""
    from repro_torch.kernels.selective_scan.ref import \
        Recurrence as _Recurrence
    g = torch.Generator().manual_seed(0)
    h0, a, b = (torch.randn(shape, generator=g, dtype=torch.float64)
                .requires_grad_(True)
                for shape in ((2, 3, 4), (2, 5, 3, 4), (2, 5, 3, 4)))
    assert torch.autograd.gradcheck(
        lambda h0, a, b: _Recurrence.apply(h0, a * 0.5, b.clone()),
        (h0, a, b))
    with torch.no_grad():
        hs = _Recurrence.apply(h0, a, b.clone())
        h = h0
        for t in range(5):
            h = a[:, t] * h + b[:, t]
            torch.testing.assert_close(hs[:, t], h, rtol=0, atol=1e-12)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b"])
def test_remat_policies_give_the_same_gradients(arch):
    """"full" recomputes each superblock in the backward, "dots" keeps
    its matmul outputs and recomputes the rest, "none" keeps everything:
    the same operations on the CPU, so the same loss and gradients."""
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    params = lm.params_from_jax(tcfg, _ref_tree(jcfg), device="cpu")
    b = _t(_batches(jcfg, 1, B=2, S=32)[0])
    runs = {policy: _grads_of(tcfg.replace(remat_policy=policy), params, b)
            for policy in ("full", "dots", "none")}
    loss, _, grads = runs["none"]
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], loss), policy
        for x, y in zip(tree_leaves(runs[policy][2]), tree_leaves(grads)):
            assert torch.equal(x, y), policy
