"""One K4 launch's FLOPs and bytes, from shapes alone (a model's count
is its architecture module's ``prefill_flops``, ``bench/archs``).  A
multiply-add is 2 FLOPs."""
from __future__ import annotations


def k4_launch(B: int, S: int, H: int, KV: int, hd: int,
              elem_bytes: int = 2) -> tuple:
    """(FLOPs, bytes) one causal K4 launch needs: the score and value
    products over the S(S+1)/2 pairs each head has, q, k and v read
    once and the output written once."""
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    nbytes = elem_bytes * B * S * hd * (2 * H + 2 * KV)
    return flops, nbytes
