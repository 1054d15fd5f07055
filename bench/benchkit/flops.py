"""Operations and bytes: the model's FLOPs for the prompts a window
served, and one K4 launch's FLOPs and bytes, from shapes alone.

The model count is the useful work: real tokens only, causal attention
over the (query, key) pairs a prompt has, MoE at its top-k experts, a
head of the two logits read.  ``executed=True`` counts instead what the
program's operations multiply, as ``launch.op_cost`` sees them: every
padded position, the whole score square, every capacity slot of every
expert, and of Mamba's scan only its one product (C . h); the tests
hold that form against op_cost.  A multiply-add is 2 FLOPs.
"""
from __future__ import annotations

from benchkit.spec import capacity


def attn_flops(d: dict, n_tok: int, pairs: int) -> int:
    """Projections of ``n_tok`` tokens, products over ``pairs`` (q, k)."""
    D, H, KV, hd = d["D"], d["H"], d["KV"], d["hd"]
    return n_tok * 2 * D * hd * (2 * H + 2 * KV) + 4 * H * hd * pairs


def mamba_flops(d: dict, n_tok: int, executed: bool = False) -> int:
    D, di, ds, dr, dc = d["D"], d["di"], d["ds"], d["dr"], d["dc"]
    proj = 2 * D * 2 * di + 2 * di * (dr + 2 * ds) + 2 * dr * di + 2 * di * D
    scan = 2 * di * ds if executed else 9 * di * ds + 2 * dc * di
    return n_tok * (proj + scan)


def ffn_flops(d: dict, n_tok: int) -> int:
    return n_tok * 6 * d["D"] * d["F"]


def moe_flops(d: dict, n_tok: int, slots: int) -> int:
    """Router for ``n_tok`` tokens, SwiGLU experts over ``slots`` rows."""
    return n_tok * 2 * d["D"] * d["E"] + ffn_flops(d, slots)


def head_flops(d: dict, n_rows: int, n_logits: int = 2) -> int:
    return n_rows * 2 * d["D"] * n_logits


def prefill_flops(d: dict, lens, T: int = 0, executed: bool = False) -> int:
    """FLOPs of one yes/no prefill of prompts of ``lens`` tokens (padded
    to ``T`` when ``executed``)."""
    total = 0
    for L in lens:
        L = int(L)
        n = T if executed else L
        pairs = n * n if executed else L * (L + 1) // 2
        slots = (d["E"] * capacity(d["K"], n, d["E"], d["cf"]) if executed
                 else L * d["K"])
        for mixer, ffn in d["layers"]:
            total += (attn_flops(d, n, pairs) if mixer == "attn"
                      else mamba_flops(d, n, executed))
            total += moe_flops(d, n, slots) if ffn == "moe" else ffn_flops(d, n)
        total += head_flops(d, 1)
    return total


def k4_launch(B: int, S: int, H: int, KV: int, hd: int,
              elem_bytes: int = 2) -> tuple:
    """(FLOPs, bytes) one causal K4 launch needs: the score and value
    products over the S(S+1)/2 pairs each head has, q, k and v read
    once and the output written once."""
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    nbytes = elem_bytes * B * S * hd * (2 * H + 2 * KV)
    return flops, nbytes
