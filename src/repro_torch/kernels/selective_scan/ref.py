"""Plain PyTorch version: Mamba-1's selective scan, chunked along S.

The model's own recurrence, as ``models.layers.mamba_scan`` ran it before
K6: a float32 recurrence within each chunk of ``chunk`` positions, carried
across chunks, then the read-out through C, the skip D x and the gate
silu(z).  It is the CPU's route and the route of every call that K6 cannot
take (autograd recording, a DTensor, a meta tensor), so it keeps its
backward (``Recurrence``), its partition rule and its meta stand-in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import partition
from repro_torch.distributed.api import shard_act
from repro_torch.distributed.partition import by_rule


class Recurrence(torch.autograd.Function):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h0 -> every h_t, written
    over ``b`` in place (one ``addcmul_`` a position; ``b`` is a
    temporary of the caller's).  Autograd cannot differentiate those
    writes, so the backward is written here: with G_t the loss's
    gradient with respect to h_t through every later step, G_t = g_t +
    a_{t+1} G_{t+1}, and the inputs' gradients are G_t (b_t),
    G_t h_{t-1} (a_t) and a_0 G_0 (h0)."""

    @staticmethod
    def forward(ctx, h0, a, b):
        b[:, 0].addcmul_(a[:, 0], h0)
        carry(b, a[:, 1:], reverse=False)
        ctx.mark_dirty(b)
        ctx.save_for_backward(h0, a, b)
        return b

    @staticmethod
    def backward(ctx, g):
        h0, a, hs = ctx.saved_tensors
        G = g.clone(memory_format=torch.contiguous_format)
        carry(G, a[:, 1:], reverse=True)
        prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
        return a[:, 0] * G[:, 0], G * prev, G


def carry(x, c, reverse: bool, stepwise=None) -> None:
    """In place, one position after another along axis 1 (T positions):
    x[:, t] += c[:, t - 1] * x[:, t - 1] for t = 1 .. T - 1, or with
    ``reverse`` x[:, t] += c[:, t] * x[:, t + 1] for t = T - 2 .. 0
    (``c`` has T - 1 positions).  A meta tensor (the dry run) has no
    values to carry, so there one operation over every position stands
    in for the loop (unless ``stepwise``): it reads, multiplies and
    writes the same elements, so ``launch.op_cost`` counts the same
    FLOPs, bytes and peak, without the loop's T operations a chunk."""
    if stepwise is None:
        stepwise = not x.is_meta
    if not stepwise:
        dst, src = (x[:, :-1], x[:, 1:]) if reverse else (x[:, 1:], x[:, :-1])
        dst.addcmul_(c, src)
        return
    for t in (range(x.shape[1] - 2, -1, -1) if reverse
              else range(1, x.shape[1])):
        s = t + 1 if reverse else t - 1
        x[:, t].addcmul_(c[:, min(s, t)], x[:, s])


@by_rule(partition.recurrence)
def recurrence(h0, a, b):
    return Recurrence.apply(h0, a, b)


def ssm_chunk(h, dt_c, B_c, C_c, x_c, A, Dp):
    """One chunk of the selective scan, carried from state h (B,di,ds).

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, stepped over the chunk in
    place of the reference's associative scan (the same recurrence; the
    float order differs) by ``Recurrence``, which differentiates it.
    The chunk's (B, c, di, ds) decay and input tensors are its transient
    memory.  Returns (h_final, y (B,c,di)).
    """
    a = torch.exp(dt_c[..., None] * A)                       # (B,c,di,ds)
    b = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
    hs = recurrence(h, a, b)
    y = torch.einsum("bcds,bcs->bcd", hs, C_c) + Dp * x_c
    return hs[:, -1].clone(), y


def selective_scan_ref(x, dt, B, C, z, A, D, h0=None, *, chunk=None,
                       remat=False):
    """x, z (Bt,S,di); dt (Bt,S,di), B, C (Bt,S,ds), A (di,ds), D (di,),
    h0 (Bt,di,ds) float32 -> (y (Bt,S,di) in x's dtype, h_last (Bt,di,ds)
    float32).

    ``chunk`` positions a chunk (all of S by default) bound the (Bt,
    chunk, di, ds) intermediates.  ``remat``: each chunk's stacks are
    recomputed in the backward, not kept (the reference's remat_inner).
    """
    Bt, S, di = x.shape
    ck = min(chunk or S, S)
    xf = x.float()
    h = (torch.zeros((Bt, di, A.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0)
    ys = []
    for lo in range(0, S, ck):  # full chunks, then the tail
        sl = slice(lo, min(lo + ck, S))
        args = (h, dt[:, sl], B[:, sl], C[:, sl], xf[:, sl], A, D)
        h, y = (checkpoint(ssm_chunk, *args, use_reentrant=False) if remat
                else ssm_chunk(*args))
        ys.append(y)
    y = shard_act(torch.cat(ys, dim=1), ("batch", None, "inner"))
    return (y * F.silu(z.float())).to(x.dtype), h
