"""The architecture modules read what the harness read before they were
split out of it: the FLOP counts at the published widths, the weights
and the reference's logits at smoke widths, pinned bit for bit to the
values that the harness gave when this layout was written into it."""
import hashlib

import numpy as np
import pytest
import torch

from benchkit import data, spec, text

# prefill_flops over the prompt lengths of the tc mix's first 2,000 rows
# (query 0's predicate): the model count, and the executed one at T 32, 64
FLOPS = {
    "jamba.tc": (717372954247168, 1101424263168000, 2202982711296000),
    "internvl2.tc": (2319811767828480, 2399007719424000, 4802847227904000),
}
# make_params at smoke widths, seed 1, float32, on the CPU
DIGEST = {
    "jamba.tc":
        "6891207894efafeb99f04829e0ad03416c189395bf0e1176309589a8d5929c45",
    "internvl2.tc":
        "96e8b2d2e5b084a291cd04ed410abdb8c854e7a6935849539d42591f2b3d3064",
}
# the reference's (yes, no) logits of 8 fixed prompts with those weights
LOGITS = {
    "jamba.tc": [
        "-0x1.1b1a100000000p-3", "-0x1.35e9a00000000p-3",
        "0x1.9be7960000000p-4", "0x1.483f720000000p+0",
        "0x1.660b280000000p+0", "-0x1.a4d4700000000p-3",
        "0x1.6734ec0000000p+0", "0x1.0b32280000000p+1",
        "0x1.304b540000000p-3", "0x1.865a840000000p-1",
        "0x1.7476900000000p-4", "-0x1.1f1fa80000000p+0",
        "0x1.750bc00000000p-1", "-0x1.8869ae0000000p-1",
        "0x1.453eb40000000p-2", "0x1.1454b80000000p-3"],
    "internvl2.tc": [
        "0x1.1392bc0000000p-3", "-0x1.2d91b00000000p-1",
        "0x1.1723220000000p+0", "0x1.2560860000000p-1",
        "-0x1.5491240000000p+0", "-0x1.5aa0540000000p-1",
        "-0x1.9401480000000p+0", "0x1.e3c1e40000000p-1",
        "0x1.4d69860000000p-2", "0x1.19c7440000000p-1",
        "0x1.90da100000000p-5", "-0x1.2abefa0000000p-1",
        "-0x1.421f340000000p+0", "-0x1.3f0fd00000000p-2",
        "0x1.2198be0000000p+0", "0x1.171af00000000p+0"],
}
WORKLOADS = sorted(FLOPS)


@pytest.fixture(scope="module")
def tc_lens():
    cs = spec.cell("jamba.tc")
    table = data.Table(cs["mix"], "cpu")
    pred = data.predicate(cs["mix"], 0)
    return [len(text.prompt_ids(pred, table.texts[i], 65536))
            for i in range(2000)]


def _smoke_params(smoke, workload):
    conf = smoke(workload)["config"]
    arch = spec.arch(conf)
    d = arch.dims(conf)
    return arch, d, arch.make_params(d, 1, torch.float32, "cpu")


def _digest(tree: dict, layers: list) -> str:
    """sha256 over every tensor's path and bytes: the top-level leaves,
    then each layer in order, keys sorted."""
    h = hashlib.sha256()

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        else:
            h.update(prefix.encode())
            h.update(node.contiguous().numpy().tobytes())
    for k in ("embed", "lm_head", "final_norm"):
        if k in tree:
            walk(k, tree[k])
    for i, layer in enumerate(layers):
        walk(f"layer{i}", layer)
    return h.hexdigest()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_flops_at_published_widths(tc_lens, workload):
    conf = spec.cell(workload)["config"]
    arch = spec.arch(conf)
    d = arch.dims(conf)
    got = (arch.prefill_flops(d, tc_lens),
           arch.prefill_flops(d, tc_lens, T=32, executed=True),
           arch.prefill_flops(d, tc_lens, T=64, executed=True))
    assert got == FLOPS[workload]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_weights_digest(smoke, workload):
    arch, _, params = _smoke_params(smoke, workload)
    assert _digest(params, arch.layer_list(params)) == DIGEST[workload]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_logits(smoke, workload):
    arch, d, params = _smoke_params(smoke, workload)
    rng = np.random.default_rng(8)
    lens = torch.tensor(rng.integers(17, 33, 8))
    toks = torch.zeros((8, 32), dtype=torch.long)
    for b, n in enumerate(lens.tolist()):
        toks[b, :n] = torch.tensor(rng.integers(8, d["V"], n))
    out = arch.yes_no_logits(d, params, arch.layer_list(params), toks, lens,
                             torch.tensor([text.YES, text.NO]))
    assert [float(x).hex() for x in out.flatten().tolist()] == \
        LOGITS[workload]
