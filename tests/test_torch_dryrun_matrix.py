"""The dry run's smoke cells of all ten assigned archs, on the CPU.

``tests/test_torch_dryrun.py`` holds qwen1.5-0.5b, jamba-v0.1-52b and
whisper-base on both meshes; here every arch of the matrix
(falcon-mamba-7b, mixtral-8x22b, dbrx-132b, internvl2-26b, gemma3-12b,
stablelm-12b and codeqwen1.5-7b besides those three) runs a train, a
prefill and a decode cell on the pod mesh (batch 32, length 32, their
smoke configs), built as partitioned programs on a ``fake`` group
of 256 ranks: the bytes one device holds of the parameters, the
optimizer state, the cache and the inputs, and the program's argument
bytes, equal the reference's shard shapes (its ``MeshRules`` on a
``jax.sharding.AbstractMesh``, its trees from ``eval_shape``).  A
``long_500k``-style gemma3 decode (one sequence, a cache of 512 slots
split over ("data", "model"), ``kv_seq_long``) reads every attention
layer's slot-split cache through ``partition._sdpa_split_keys``.

What makes the production cells' meta traces cheaper counts what the
plain loops count: the chunked attention's blocks replayed by
``launch.op_cost.replayed`` (the same FLOPs, bytes, peak and sites as
running every block) and the Mamba recurrence as one operation over its
positions on meta tensors (the loop's counts; on real tensors the loop,
value for value).

The production matrix (80 cells) runs as a script, not here:
``python -m repro_torch.launch.dryrun --all --mesh both``.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import input_specs as jinput_specs
from repro.configs import smoke_config as jsmoke
from repro.distributed.rules import MeshRules as JMeshRules
from repro.models import lm as jlm
from repro.models.config import ShapeCell as JShapeCell
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import opt_logical_axes as jopt_logical_axes
from repro_torch.configs import smoke_config
from repro_torch.distributed import partition
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import lm
from repro_torch.models.config import ShapeCell
from repro_torch.utils.tree import tree_leaves
from test_torch_dryrun import _ref_batch_axes, _ref_bytes

ARCHS = dryrun.ASSIGNED  # the ten of the matrix
POD = ((16, 16), ("data", "model"))


def _ref_cell(arch, shape, long_context=False):
    """The reference's per-device bytes of one pod cell: its trees, its
    rules on an abstract mesh, NamedSharding's shard shapes."""
    cfg = jsmoke(arch)
    jrules = JMeshRules(AbstractMesh(*POD))
    p_axes = jlm.param_logical_axes(cfg)
    params = jlm.abstract_params(cfg)
    specs = jinput_specs(cfg, shape)
    out = {"params": _ref_bytes(jrules, p_axes, params),
           "inputs": _ref_bytes(jrules, _ref_batch_axes(specs),
                                {k: v for k, v in specs.items()
                                 if k != "cache"})}
    if shape.kind == "train":
        oc = JOptConfig()
        opt = jax.eval_shape(lambda p: jadamw_init(p, oc), params)
        out["opt"] = _ref_bytes(jrules, jopt_logical_axes(p_axes, oc), opt)
    elif shape.kind == "prefill":
        cache = jax.eval_shape(lambda p, s: jlm.prefill(
            cfg, p, s["tokens"], prefix_embeds=s.get("prefix_embeds"),
            enc_frames=s.get("enc_frames"), max_len=shape.seq_len)[1],
            params, specs)
        out["cache"] = _ref_bytes(jrules, jlm.cache_logical_axes(cfg), cache)
    else:
        out["cache"] = _ref_bytes(
            jrules, jlm.cache_logical_axes(cfg, long_context=long_context),
            specs["cache"])
    return out


def _check_cell(art, want, kind):
    assert art["ok"] and art["chips"] == 256
    assert art["per_device_bytes"] == want
    # the program's arguments: the parameters, the optimizer state or
    # the cache it takes, and the inputs (a prefill makes its cache)
    taken = {"train": ("params", "opt", "inputs"),
             "prefill": ("params", "inputs"),
             "decode": ("params", "cache", "inputs")}[kind]
    assert art["memory"]["argument_size_in_bytes"] == sum(
        want[k] for k in taken)
    assert art["memory"]["output_size_in_bytes"] > 0
    assert art["memory"]["temp_size_in_bytes"] > 0
    if kind != "decode":
        # at least its share of the step; a decode step's attention over
        # a block of one slot a rank multiplies its probabilities by the
        # values elementwise (an einsum over one key), which the counter
        # counts no FLOPs for, so there a device reads just under its share
        assert art["cost"]["flops_per_device"] >= art["cost"]["flops"] / 256
    terms = art["roofline_terms"]
    assert art["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert terms[art["dominant"]] == max(
        terms[k] for k in ("compute_s", "memory_s", "collective_s"))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_bytes_per_device_equal_the_reference(arch, kind):
    shape = ShapeCell(f"smoke_{kind}", 32, 32, kind)
    art = dryrun.build_cell(arch, f"smoke_{kind}", "pod",
                            cfg=smoke_config(arch), shape=shape)
    _check_cell(art, _ref_cell(arch, JShapeCell(f"smoke_{kind}", 32, 32,
                                                kind)), kind)
    if kind == "train":
        # one device's temporaries: never the whole optimizer state
        n = sum(t.numel() for t in
                tree_leaves(lm.abstract_params(smoke_config(arch))))
        assert art["memory"]["temp_size_in_bytes"] < 3 * 4 * n


def test_long_context_smoke_decode_reads_a_cache_split_over_two_axes(
        monkeypatch):
    """gemma3-12b smoke as ``long_500k`` is cut: one sequence over a cache
    of 512 slots, the global layer's split 256 ways over ("data",
    "model") and the ring buffers' (16 slots) over "model"; every
    attention layer reads its block of slots and reduces the softmax
    over the groups that split them."""
    calls = []
    split_keys = partition._sdpa_split_keys

    def counted(*args, groups, **kwargs):
        calls.append(len(groups))
        return split_keys(*args, groups=groups, **kwargs)

    monkeypatch.setattr(partition, "_sdpa_split_keys", counted)
    cfg = smoke_config("gemma3-12b")
    art = dryrun.build_cell("gemma3-12b", "long_500k", "pod", cfg=cfg,
                            shape=ShapeCell("long_500k", 512, 1, "decode"))
    want = _ref_cell("gemma3-12b", JShapeCell("long_500k", 512, 1, "decode"),
                     long_context=True)
    _check_cell(art, want, "decode")
    # a superblock's five ring buffers split over model alone, its
    # global layer's cache over data and model
    windows = [spec.window for spec in cfg.pattern] * cfg.n_superblocks
    assert calls == [1 if w else 2 for w in windows]


def _share(art):
    """A device's FLOPs over its share of the whole step's."""
    return art["cost"]["flops_per_device"] * art["chips"] / art["cost"]["flops"]


def test_batch_one_moe_cell_runs_its_share_of_the_experts():
    """mixtral-8x22b smoke as ``long_500k`` is cut (one sequence, 512
    slots), its expert FFN widened to 2,048 so that the expert products
    carry the step, as at full width: the data axis splits neither the
    batch nor the 4 experts, so each data rank takes its block of the
    buffer's D columns (``partition.experts``), and a device runs its
    share of the step (the whole expert products on every data rank
    read 15.7x)."""
    cfg = smoke_config("mixtral-8x22b").replace(d_ff=2048)
    art = dryrun.build_cell("mixtral-8x22b", "long_500k", "pod", cfg=cfg,
                            shape=ShapeCell("long_500k", 512, 1, "decode"))
    assert art["ok"] and _share(art) <= 1.10


def test_uneven_frame_whisper_cell_runs_its_share_of_the_step():
    """whisper-base smoke with 40 encoder frames (over 16 model ranks,
    where its 4 heads do not divide either): q's rows are padded to 48,
    3 a rank, in the encoder's forward and backward, and a train step's
    device runs its share of the step (whole encoder attention on every
    model rank read 2.26x)."""
    cfg = smoke_config("whisper-base").replace(encoder_len=40)
    art = dryrun.build_cell("whisper-base", "smoke_train", "pod", cfg=cfg,
                            shape=ShapeCell("smoke_train", 32, 32, "train"))
    assert art["ok"] and _share(art) <= 1.10


# --------------------------- the meta trace made cheaper, counts equal


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _counts(cost):
    return (cost.flops, cost.bytes, cost.peak_bytes, cost.by_site,
            cost.peak_by_site)


@pytest.mark.parametrize("schedule", ["rect", "tri", "banded"])
def test_replayed_chunk_blocks_count_what_every_block_counts(schedule):
    """A prefill's chunked attention on meta tensors (B 2, S 256 over
    chunks of 32, 4 query heads over 2 KV heads, bf16): the counter
    that replays ``_online_block`` counts the FLOPs, bytes, peak and
    sites of the counter that runs every block."""
    from repro_torch.models.layers import _chunked_sdpa
    q = _meta(2, 256, 4, 16, dtype=torch.bfloat16)
    k, v = (_meta(2, 256, 2, 16, dtype=torch.bfloat16) for _ in range(2))
    rows = _meta(2, 256, dtype=torch.int64) if schedule == "banded" else None
    kw = dict(causal=True, window=48 if schedule == "banded" else None,
              cq=32, ck=32, schedule=schedule)
    with torch.no_grad():
        with OpCost(replay=False) as every:
            _chunked_sdpa(q, k, v, rows, 0.25, **kw)
        with OpCost() as replayed:
            _chunked_sdpa(q, k, v, rows, 0.25, **kw)
    assert every.flops > 0 and every.peak_bytes > 0
    assert _counts(replayed) == _counts(every)
    assert len(replayed._tapes) == 1  # one block recorded, the rest replayed


@pytest.mark.parametrize("reverse", [False, True])
def test_recurrence_on_meta_counts_what_its_loop_counts(reverse):
    """The Mamba recurrence's carry (``selective_scan.ref.carry``) on meta
    tensors: one operation over every position counts the loop's FLOPs,
    bytes and peak."""
    from repro_torch.kernels.selective_scan.ref import carry as _carry

    def run(stepwise):
        x, c = _meta(2, 64, 8, 4), _meta(2, 63, 8, 4)
        with OpCost() as cost:
            _carry(x, c, reverse, stepwise=stepwise)
        return _counts(cost)

    assert run(True) == run(None)
    assert run(None)[1] == 4 * 63 * 2 * 8 * 4 * 4  # x, c, x read; x written


def test_recurrence_carry_values_equal_the_loop():
    """On real tensors ``carry`` is the recurrence's loop as it was
    written, value for value."""
    from repro_torch.kernels.selective_scan.ref import carry as _carry
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 9, 3, 4, generator=g)
    a = torch.rand(2, 9, 3, 4, generator=g)
    got, want = x.clone(), x.clone()
    _carry(got, a[:, 1:], reverse=False)
    for t in range(1, 9):
        want[:, t].addcmul_(a[:, t], want[:, t - 1])
    assert torch.equal(got, want)
    got, want = x.clone(), x.clone()
    _carry(got, a[:, 1:], reverse=True)
    for t in range(7, -1, -1):
        want[:, t].addcmul_(a[:, t + 1], want[:, t + 1])
    assert torch.equal(got, want)
