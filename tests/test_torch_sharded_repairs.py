"""Two layouts of the partitioned program that the reference's GSPMD
gives and DTensor does not find on its own, on a real 4-rank gloo group
on the CPU (four processes of their own, a FileStore), against the
unpartitioned port.

- The expert products at batch 1 (``partition.experts``): one sequence
  splits over no mesh dim, so the (data 2, model 2) mesh's data axis
  splits only the cache's slots (``kv_seq_long``) and the weights' FSDP
  "embed" shard of D.  There each rank takes its block of the buffer's
  D columns, the gate and up products are Partial sums reduced before
  the SiLU, and the down product's output lies split along D: mixtral
  and jamba smoke configs (4 experts over model), a prefill and 3
  decode steps, and one train step.
- whisper-base smoke with 2 heads and 13 encoder frames on the (data 1,
  model 4) mesh, where neither the heads nor the frames divide the
  model axis: q's rows are padded to 16, 4 a rank (the last rank's last
  3 are padding), in the encoder's forward (``lm.encode``), a train
  step and a prefill; then decode steps, whose cross attention has one
  query row a sequence: each model rank takes one head's half of hd
  (``partition._own_head_slice``), as GSPMD splits the flat heads x hd.

Each rank reports which layouts ran, so a case cannot pass on an
older one.  Tolerances are ``tests/test_torch_sharded.py``'s: a train
step's metrics and leaves within ``tests/test_torch_train.py``'s (its
moments hold the gradients), logits, an encoder's output and a decoded
cache 1e-4, a prefill's cache 1e-5.
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
MAX_LEN, STEPS = 24, 3
WHISPER = ("whisper-base", {"n_heads": 2, "n_kv_heads": 2, "encoder_len": 13})
# (arch, config overrides, (data, model), batch, length, long_context)
CASES = [("mixtral-8x22b", {}, (2, 2), 1, 16, True),
         ("jamba-v0.1-52b", {}, (2, 2), 1, 16, True),
         (*WHISPER, (1, 4), 2, 16, False)]
# the layouts each case must run: expert kinds, padded rows, head slices
RAN = [{"embed", "experts"}, {"embed", "experts"}, {"rows", "heads"}]


def _cfg(arch, overrides):
    cfg = smoke_config(arch)
    return cfg.replace(**overrides) if overrides else cfg


_RANK = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.configs import input_logical_axes, smoke_config
    from repro_torch.distributed import partition
    from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                             partitioned, sharding_context)
    from repro_torch.distributed.rules import MeshRules
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import opt_logical_axes
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map
    work, rank = sys.argv[1], int(sys.argv[2])
    cases = json.loads(sys.argv[3])
    dist.init_process_group(
        "gloo", store=dist.FileStore(work + "/store", 4), rank=rank,
        world_size=4, timeout=datetime.timedelta(seconds=300))
    ran = set()  # the layouts the rules took, as the report names them
    kinds, resize, heads = (partition._expert_kinds, partition._resize_rows,
                            partition._own_head_slice)

    def seen_kinds(*args):
        out = kinds(*args)
        ran.update(k for k in out if k)
        return out

    def seen(name, fn):
        def run(*args, **kwargs):
            ran.add(name)
            return fn(*args, **kwargs)
        return run

    partition._expert_kinds = seen_kinds
    partition._resize_rows = seen("rows", resize)
    partition._own_head_slice = seen("heads", heads)
    meshes, report = {}, []

    def rules_of(shape):
        if tuple(shape) not in meshes:  # every rank makes them in order
            meshes[tuple(shape)] = make_local_mesh(*shape, device="cpu")
        return MeshRules(meshes[tuple(shape)])

    def save(name, tree):
        out = gather_tree(tree)
        if rank == 0:
            np.savez(f"{work}/{name}.npz", **{
                k: v.detach().float().numpy()
                for k, v in tree_leaves_with_path(out)})

    try:
        oc = OptConfig(lr=%(lr)r, warmup_steps=2, total_steps=50)
        for i, (arch, over, shape, _, _, long_ctx) in enumerate(cases):
            ran.clear()
            cfg, rules = smoke_config(arch).replace(**over), rules_of(shape)
            data = {k: torch.from_numpy(v) for k, v in
                    np.load(f"{work}/case{i}.npz").items()}
            with sharding_context(rules):
                params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
                axes = {"params": lm.param_logical_axes(cfg)}
                axes["opt"] = opt_logical_axes(axes["params"], oc)
                state = distribute_tree(
                    {"params": params, "opt": adamw_init(params, oc)},
                    axes, rules)
                batch = {k: data[k] for k in ("tokens", "targets",
                                              "enc_frames") if k in data}
                p, o, m = make_train_step(cfg, oc)(
                    state["params"], state["opt"],
                    distribute_tree(batch, input_logical_axes(batch), rules))
                save(f"train{i}", {"params": p, "opt": o, "metrics": m})

                dp = state["params"]
                out = {}
                with partitioned(dp), torch.no_grad():
                    extra = {}
                    if "enc_frames" in data:
                        extra["enc_frames"] = distribute_tree(
                            data["enc_frames"], ("batch", None, None), rules)
                        out["encode"] = lm.encode(cfg, dp,
                                                  extra["enc_frames"])
                    logits, cache, _ = lm.prefill(
                        cfg, dp, distribute_tree(data["prompt"].long(),
                                                 ("batch", None), rules),
                        max_len=%(max_len)r, **extra)
                    cache = distribute_tree(
                        cache, lm.cache_logical_axes(cfg, long_ctx), rules)
                    out["prefill"] = logits  # a decode writes the cache
                    out["prefill_cache"] = tree_map(torch.clone,
                                                    gather_tree(cache))
                    pos = distribute_tree(data["pos"].long(), ("kv_batch",),
                                          rules)
                    for s, cur in enumerate(data["steps"]):
                        logits, cache = lm.decode_step(
                            cfg, dp, cache, distribute_tree(
                                cur.long(), ("kv_batch",), rules), pos)
                        out[f"step{s}"] = logits
                        pos = pos + 1
                    out["cache"] = cache
                save(f"serve{i}", out)
            report.append(sorted(ran))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report))
""") % {"lr": LR, "max_len": MAX_LEN}


def _inputs(arch, overrides, b, s, seed):
    """A train batch, a prompt of ``s`` tokens a row, and STEPS tokens a
    row decoded from positions on either side of the ranks' slot blocks
    (6 of the 24 slots a rank over data and model, 12 over model)."""
    cfg = _cfg(arch, overrides)
    rng = np.random.default_rng(300 + seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
           "prompt": rng.integers(0, cfg.vocab_size, (b, s)),
           "steps": rng.integers(0, cfg.vocab_size, (STEPS, b)),
           "pos": np.array([s - 5, s + 1][:b])}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Four gloo ranks in processes of their own run every case; rank 0
    writes the gathered results and the layouts each case ran."""
    work = tmp_path_factory.mktemp("gloo_repairs")
    for i, (arch, over, _, b, s, _) in enumerate(CASES):
        np.savez(work / f"case{i}.npz", **_inputs(arch, over, b, s, i))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), str(r), json.dumps(CASES)],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return work, json.loads(outs[0][0].strip().splitlines()[-1])


IDS = [f"{c[0]}-{c[2][0]}x{c[2][1]}-b{c[3]}" for c in CASES]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_repaired_layouts_ran(case, gloo_run):
    _, report = gloo_run
    assert RAN[case] <= set(report[case]), report[case]


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_partitioned_train_step_equals_the_unpartitioned_one(case,
                                                              gloo_run):
    work, _ = gloo_run
    arch, over, _, _, _, _ = CASES[case]
    cfg = _cfg(arch, over)
    oc = OptConfig(lr=LR, warmup_steps=2, total_steps=50)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    data = np.load(work / f"case{case}.npz")
    batch = {k: torch.from_numpy(data[k])
             for k in ("tokens", "targets", "enc_frames") if k in data}
    p, o, m = make_train_step(cfg, oc)(params, adamw_init(params, oc), batch)
    got = dict(np.load(work / f"train{case}.npz"))
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


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_partitioned_serving_equals_the_unpartitioned_one(case, gloo_run):
    """The encoder's output (whisper), a prefill and decode steps: within
    1e-4 (the encoder, logits, a decoded cache) and 1e-5 (a prefill's
    cache) of the unpartitioned port's."""
    work, _ = gloo_run
    arch, over, _, _, _, _ = CASES[case]
    cfg = _cfg(arch, over)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    data = {k: torch.from_numpy(v) for k, v in
            np.load(work / f"case{case}.npz").items()}
    got = dict(np.load(work / f"serve{case}.npz"))
    want = {}
    with torch.no_grad():
        extra = {}
        if "enc_frames" in data:
            extra["enc_frames"] = data["enc_frames"]
            want["encode"] = lm.encode(cfg, params, data["enc_frames"]).numpy()
        logits, cache, _ = lm.prefill(cfg, params, data["prompt"].long(),
                                      max_len=MAX_LEN, **extra)
        want.update(prefill=logits.numpy(),
                    **_cache_leaves(cache, "prefill_cache"))
        pos = data["pos"].long()
        for s, cur in enumerate(data["steps"]):
            logits, cache = lm.decode_step(cfg, params, cache, cur.long(),
                                           pos)
            want[f"step{s}"] = logits.numpy()
            pos = pos + 1
        want.update(_cache_leaves(cache, "cache"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        tol = 1e-5 if k.startswith("prefill_cache") else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=k)
