"""A new architecture is new files only: a configuration and a module
written beside the harness, found by the configuration's ``"arch"`` key,
run a whole smoke cell (window, CSV check, logit check) with no edit to
``benchkit/``, ``archs/decoder.py`` or BENCHMARK.json."""
import json

import run as R
from benchkit import spec

# Granite-style: the layout is a list of layer types, every layer's FFN an
# MoE; the layer math (Mamba-1 here, as the program has it) is decoder's.
MODULE = '''"""A hybrid laid out by a ``layer_types`` list, with an MoE of
``num_local_experts`` in every layer; the layer math is decoder's."""
from archs import decoder
from archs.decoder import (layer_list, make_params, prefill_flops,
                           program_config, yes_no_logits)

MIXERS = {"mamba": "mamba", "attention": "attn"}


def dims(conf):
    d = decoder.dims(conf)
    d.update(E=conf["num_local_experts"], K=conf["num_experts_per_tok"],
             layers=[(MIXERS[t], "moe") for t in conf["layer_types"]])
    return d


def smoke(conf):
    conf.update(decoder.SMOKE_WIDTHS, num_local_experts=4,
                num_experts_per_tok=2, mamba_dt_rank=4)
'''

CONFIG = {
    "name": "typed-hybrid", "arch": "typed_hybrid",
    "hidden_size": 1536, "intermediate_size": 768, "num_hidden_layers": 4,
    "layer_types": ["mamba", "attention", "mamba", "mamba"],
    "num_attention_heads": 12, "num_key_value_heads": 4,
    "num_local_experts": 72, "num_experts_per_tok": 10,
    "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_expand": 2,
    "mamba_dt_rank": 96, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": True, "vocab_size": 100352,
    "serving": {"family": "hybrid", "dtype": "bfloat16", "attn_impl": "flash",
                "capacity_factor": 1.25, "moe_chunk": 1024, "max_batch": 64},
}


def test_new_architecture_runs_a_smoke_cell(smoke, tmp_path, monkeypatch):
    (tmp_path / "typed_hybrid.py").write_text(MODULE)
    (tmp_path / "typed-hybrid.json").write_text(json.dumps(CONFIG))
    cs = smoke(rows=2000, dim=32)
    monkeypatch.setattr(spec, "ARCHS", tmp_path)
    conf = spec.load_json(tmp_path / "typed-hybrid.json")
    arch = spec.arch(conf)
    assert arch.__file__ == str(tmp_path / "typed_hybrid.py")
    arch.smoke(conf)
    conf["serving"]["dtype"] = "float32"
    cs["config"] = conf
    mcfg = arch.program_config(conf, arch.dims(conf))
    assert [(s.kind, s.ffn) for s in mcfg.pattern] == \
        [("mamba", "moe"), ("attn", "moe"), ("mamba", "moe"), ("mamba", "moe")]
    assert (mcfg.n_experts, mcfg.top_k) == (4, 2)
    out = R.run(cs, 3, 0.0, False, device="cpu", t_start=0.0)
    assert out["correct"], out["checks"]
    assert {"route_diff", "logit_err", "ids_diff"} <= out["checks"].keys()
