"""The partitioned program of the families ``tests/test_torch_sharded.py``
leaves out, on a real 4-rank gloo group on the CPU (four processes of
their own, a FileStore), against the unpartitioned port.

- gemma3-12b smoke: a train step and a prefill with decode steps, its
  five sliding-window layers on the banded chunked schedule (S 32 over
  chunks of 16) and its ring buffers, its global layer on plain
  attention; on the (data 2, model 2) mesh its 2 KV heads divide the
  model axis.
- The same with one KV head (``n_kv_heads=1``), which does not divide
  the model axis: each model rank keeps its 2 of the 4 query heads and
  reads the one KV head (``partition._own_heads``), in the train step,
  the chunked and plain schedules and the decode step; and
  stablelm-12b smoke on a (data 1, model 4) mesh, one query head a rank
  over 2 KV heads, in a train step and a prefill with decode steps.
- whisper-base smoke with 2 heads on the (1, 4) mesh, where neither the
  heads nor the KV heads divide the model axis: each model rank takes
  its rows of the queries (``partition._own_rows``) in the encoder, the
  decoder and the cross attention, in a train step and serving.
- internvl2-26b smoke: a prefill with its 4 prefix embeddings, then
  decode steps.
- whisper-base smoke: a prefill of the encoder frames and the prompt,
  then decode steps through cross attention.
- ``partition.matmul_f32`` on bfloat16 DTensors placed as the dry run
  places the logits product's operands (rows over "data", the table
  over ("vocab", "embed")), with the cast product as ``fn`` (the CPU has
  no ``mm(out_dtype=)``): the logits and both gradients against the
  unpartitioned product.

Tolerances are ``tests/test_torch_sharded.py``'s: a train step's metrics
and leaves within ``tests/test_torch_train.py``'s, logits and a decoded
cache 1e-4, a prefill's cache 1e-5; ``matmul_f32``'s float32 logits
1e-5, and its bfloat16 gradients within two bfloat16 units in the last
place (2^-7) of their largest entry, as each rank rounds its Partial
share to bfloat16 before the shares are summed.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.utils.tree import tree_leaves_with_path
from test_torch_train import (METRIC_RTOL, MOMENT_ATOL, _assert_adam_close,
                              _assert_tree_close)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
LR = 3e-3
MAX_LEN, STEPS = 40, 3
# (arch, config overrides, (data, model), batch, length)
WHISPER_2 = ("whisper-base", {"n_heads": 2, "n_kv_heads": 2}, (1, 4), 2, 16)
TRAIN_CASES = [("gemma3-12b", {}, (2, 2), 4, 32),
               ("gemma3-12b", {"n_kv_heads": 1}, (2, 2), 4, 32),
               ("stablelm-12b", {}, (1, 4), 2, 16), WHISPER_2]
SERVE_CASES = [("gemma3-12b", {}, (2, 2), 4, 32),
               ("gemma3-12b", {"n_kv_heads": 1}, (2, 2), 4, 32),
               ("internvl2-26b", {}, (2, 2), 4, 16),
               ("whisper-base", {}, (2, 2), 4, 16),
               ("stablelm-12b", {}, (1, 4), 2, 16), WHISPER_2]
MM = (8, 32, 64)  # matmul_f32: rows, width, vocabulary


def _cfg(arch, overrides):
    cfg = smoke_config(arch)
    return cfg.replace(**overrides) if overrides else cfg


_RANK = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs import input_logical_axes, smoke_config
    from repro_torch.distributed import partition
    from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                             partitioned, place,
                                             sharding_context)
    from repro_torch.distributed.rules import MeshRules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import opt_logical_axes
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map
    work, rank = sys.argv[1], int(sys.argv[2])
    train_cases, serve_cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(work + "/store", 4), rank=rank,
        world_size=4, timeout=datetime.timedelta(seconds=300))
    meshes = {}

    def rules_of(shape):
        if tuple(shape) not in meshes:  # every rank makes them in order
            meshes[tuple(shape)] = make_local_mesh(*shape, device="cpu")
        return MeshRules(meshes[tuple(shape)])

    def config(arch, overrides):
        cfg = smoke_config(arch)
        return cfg.replace(**overrides) if overrides else cfg

    def save(name, tree):
        out = gather_tree(tree)
        if rank == 0:
            np.savez(f"{work}/{name}.npz", **{
                k: v.detach().float().numpy()
                for k, v in tree_leaves_with_path(out)})

    try:
        oc = OptConfig(lr=%(lr)r, warmup_steps=2, total_steps=50)
        for i, (arch, over, shape, _, _) in enumerate(train_cases):
            cfg, rules = config(arch, over), rules_of(shape)
            with sharding_context(rules):
                params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
                batch = {k: torch.from_numpy(v) for k, v in
                         np.load(f"{work}/batch{i}.npz").items()}
                axes = {"params": lm.param_logical_axes(cfg)}
                axes["opt"] = opt_logical_axes(axes["params"], oc)
                state = distribute_tree(
                    {"params": params, "opt": adamw_init(params, oc)},
                    axes, rules)
                p, o, m = make_train_step(cfg, oc)(
                    state["params"], state["opt"],
                    distribute_tree(batch, input_logical_axes(batch), rules))
                save(f"out{i}", {"params": p, "opt": o, "metrics": m})

        for i, (arch, over, shape, _, _) in enumerate(serve_cases):
            cfg, rules = config(arch, over), rules_of(shape)
            with sharding_context(rules):
                params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
                dp = distribute_tree(params, lm.param_logical_axes(cfg),
                                     rules)
                data = dict(np.load(f"{work}/serve{i}.npz"))
                extra = {k: distribute_tree(torch.from_numpy(data[k]),
                                            ("batch", None, None), rules)
                         for k in ("prefix_embeds", "enc_frames")
                         if k in data}
                out = {}
                with partitioned(dp), torch.no_grad():
                    logits, cache, _ = lm.prefill(
                        cfg, dp, distribute_tree(
                            torch.from_numpy(data["tokens"]).long(),
                            ("batch", None), rules),
                        max_len=%(max_len)r, **extra)
                    cache = distribute_tree(cache, lm.cache_logical_axes(cfg),
                                            rules)
                    out["prefill"] = logits  # a decode writes the cache
                    out["prefill_cache"] = tree_map(torch.clone,
                                                    gather_tree(cache))
                    pos = distribute_tree(torch.from_numpy(data["pos"]).long(),
                                          ("kv_batch",), rules)
                    for s, cur in enumerate(data["steps"]):
                        logits, cache = lm.decode_step(
                            cfg, dp, cache, distribute_tree(
                                torch.from_numpy(cur).long(), ("kv_batch",),
                                rules), pos)
                        out[f"step{s}"] = logits
                        pos = pos + 1
                    out["cache"] = cache
                save(f"serve_out{i}", out)

        # matmul_f32 on bfloat16 operands placed as the dry run's: the
        # rows (the batch) over data, the table over (vocab, embed)
        rules = rules_of((2, 2))
        dm = rules.mesh.device_mesh
        mm = {k: torch.from_numpy(v) for k, v in
              np.load(f"{work}/mm.npz").items()}
        h2 = place(mm["h2"].bfloat16(), dm, rules.placements(
            rules.spec(("batch", None), tuple(mm["h2"].shape))))
        table = place(mm["table"].bfloat16(), dm, rules.placements(
            rules.spec(("vocab", "embed"), tuple(mm["table"].shape))))
        h2.requires_grad_()
        table.requires_grad_()
        with partitioned(h2):
            logits = partition.matmul_f32(
                lambda a, b: a.float() @ b.float().T, h2, table)
            (logits * mm["w"]).sum().backward()
        report = {"placements": [str(t.placements)
                                 for t in (h2, table, logits)]}
        save("mm_out", {"logits": logits, "h2": h2.grad,
                        "table": table.grad})
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report))
""") % {"lr": LR, "max_len": MAX_LEN}


def _batch(arch, overrides, b, s, seed):
    cfg = _cfg(arch, overrides)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _serve_inputs(arch, overrides, b, s, seed):
    """A prompt of ``s`` tokens a row (after internvl2's prefix), the
    modality stubs, and STEPS tokens a row decoded from positions on
    either side of the ranks' slot blocks (20 of the 40 slots a model
    rank; a ring of 16)."""
    cfg = _cfg(arch, overrides)
    rng = np.random.default_rng(200 + seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, s - cfg.num_prefix_embeds)),
           "steps": rng.integers(0, cfg.vocab_size, (STEPS, b)),
           "pos": np.array([s, s - 13, s - 2, s + 1][:b])}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


def _mm_inputs():
    rng = np.random.default_rng(7)
    n, d, v = MM
    # values a bfloat16 holds exactly, so both sides start equal
    bf = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).bfloat16().float().numpy()
    return {"h2": bf(n, d), "table": bf(v, d),
            "w": rng.standard_normal((n, v)).astype(np.float32)}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Four gloo ranks in processes of their own run every case; rank 0
    writes the gathered results and a report."""
    work = tmp_path_factory.mktemp("gloo_zoo")
    for i, (arch, over, _, b, s) in enumerate(TRAIN_CASES):
        np.savez(work / f"batch{i}.npz", **_batch(arch, over, b, s, i))
    for i, (arch, over, _, b, s) in enumerate(SERVE_CASES):
        np.savez(work / f"serve{i}.npz", **_serve_inputs(arch, over, b, s, i))
    np.savez(work / "mm.npz", **_mm_inputs())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), str(r),
         json.dumps(TRAIN_CASES), json.dumps(SERVE_CASES)], env=ENV,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return work, json.loads(outs[0][0].strip().splitlines()[-1])


def _case_id(case):
    arch, over, shape = case[:3]
    kv = "".join(f"-{k}{v}" for k, v in over.items())
    return f"{arch}{kv}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)),
                         ids=[_case_id(c) for c in TRAIN_CASES])
def test_partitioned_train_step_equals_the_unpartitioned_one(case,
                                                              gloo_run):
    work, _ = gloo_run
    arch, over, _, _, _ = TRAIN_CASES[case]
    cfg = _cfg(arch, over)
    oc = OptConfig(lr=LR, warmup_steps=2, total_steps=50)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(work / f"batch{case}.npz").items()}
    p, o, m = make_train_step(cfg, oc)(params, adamw_init(params, oc), batch)
    got = dict(np.load(work / f"out{case}.npz"))
    for k, v in m.items():
        np.testing.assert_allclose(got[f"metrics/{k}"], float(v),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    as_tree = lambda prefix, tree: {  # noqa: E731
        k: torch.from_numpy(got[f"{prefix}/{k}"]).to(v.dtype)
        for k, v in tree_leaves_with_path(tree)}
    ref = lambda tree: dict(tree_leaves_with_path(tree))  # noqa: E731
    assert int(got["opt/step"]) == int(o["step"]) == 1
    _assert_adam_close(ref(p), as_tree("params", p), 2 * LR, f"{case} params")
    _assert_adam_close(ref(o["master"]), as_tree("opt/master", o["master"]),
                       2 * LR, f"{case} master")
    for k in ("mu", "nu"):
        _assert_tree_close(ref(o[k]), as_tree(f"opt/{k}", o[k]), MOMENT_ATOL,
                           f"{case} {k}")


def _cache_leaves(cache, prefix):
    """Copies of the leaves: a decode step writes the cache in place."""
    return {f"{prefix}/{k}": v.float().numpy().copy()
            for k, v in tree_leaves_with_path(cache)}


@pytest.mark.parametrize("case", range(len(SERVE_CASES)),
                         ids=[_case_id(c) for c in SERVE_CASES])
def test_partitioned_serving_equals_the_unpartitioned_one(case, gloo_run):
    """A prefill and decode steps: logits and cache as the unpartitioned
    port's within 1e-4 (logits, a decoded cache) and 1e-5 (a prefill's
    cache)."""
    work, _ = gloo_run
    arch, over, _, _, _ = SERVE_CASES[case]
    cfg = _cfg(arch, over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    data = dict(np.load(work / f"serve{case}.npz"))
    extra = {k: torch.from_numpy(data[k])
             for k in ("prefix_embeds", "enc_frames") if k in data}
    got = dict(np.load(work / f"serve_out{case}.npz"))
    with torch.no_grad():
        logits, cache, _ = lm.prefill(cfg, params,
                                      torch.from_numpy(data["tokens"]).long(),
                                      max_len=MAX_LEN, **extra)
        want = {"prefill": logits.numpy(),
                **_cache_leaves(cache, "prefill_cache")}
        pos = torch.from_numpy(data["pos"]).long()
        for s, cur in enumerate(data["steps"]):
            logits, cache = lm.decode_step(cfg, params, cache,
                                           torch.from_numpy(cur).long(), pos)
            want[f"step{s}"] = logits.numpy()
            pos = pos + 1
        want.update(_cache_leaves(cache, "cache"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        tol = 1e-5 if k.startswith("prefill_cache") else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=k)


def test_matmul_f32_on_bf16_dtensors_equals_the_product(gloo_run):
    work, report = gloo_run
    # rows over data; the table's vocabulary over model, its width over
    # data; the logits split as the rows and as the table's vocabulary
    assert report["placements"] == [
        "(Shard(dim=0), Replicate())", "(Shard(dim=1), Shard(dim=0))",
        "(Shard(dim=0), Shard(dim=1))"]
    mm = {k: torch.from_numpy(v) for k, v in
          np.load(work / "mm.npz").items()}
    h2 = mm["h2"].bfloat16().requires_grad_()
    table = mm["table"].bfloat16().requires_grad_()
    logits = h2.float() @ table.float().T
    (logits * mm["w"]).sum().backward()
    got = dict(np.load(work / "mm_out.npz"))
    np.testing.assert_allclose(got["logits"], logits.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for name, t in (("h2", h2), ("table", table)):
        want = t.grad.float().numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max(),
                                   err_msg=name)
