"""Partition rules: how each operation that DTensor cannot propagate runs
on a mesh.

DTensor propagates most operations by its own sharding rules.  A few it
cannot: ``mm`` with ``out_dtype``, sorts and scatters within a
sequence, the Mamba recurrence, einsums over placements it has no
strategy for; and some it can only plan so slowly that a production
cell would take minutes a shape (attention and the expert products
once the batch is split over two mesh axes).  Each such operation is
written once, as the plain function on plain tensors, and marked with
``@by_rule(rule)``: on plain arguments it runs as written, so one card
runs exactly what it ran before; where an argument is a DTensor,
``rule(fn, *args, **kwargs)`` runs it instead.  Every rule is here,
beside the others, and each runs ``fn`` (or its partitioned form, for
attention over a slot-split cache and the vocab-parallel log-prob) on
each rank's local shards with stated placements (``local_region``),
the layout GSPMD gives the reference's same operation.

Rules and why each exists ("cannot": no DTensor strategy; "slow":
DTensor's planner takes minutes a shape on the 3-D production mesh):

- ``sdpa``: attention, plain or chunked, on each rank's sequences and
  heads (slow; the chunked loops would run op by op on DTensors):
  where the KV heads do not divide the model axis, q keeps its split
  of the query heads and each rank computes only its own
  (``_own_heads``), and where the query heads do not divide it either,
  its own query rows (``_own_rows``, padded to even blocks), or at one
  row its head's slice of hd (``_own_head_slice``); without gradients a
  slot-split cache stays split (flash-decoding across ranks,
  ``_sdpa_split_keys``).
- ``write_slots``: a decode step's cache write, into each rank's own
  block of sequences and slots (cannot: an indexed write into a
  sharded dim).
- ``per_sequence``: MoE routing, dispatch and combine on each rank's
  own sequences (cannot: stable sort, cumulative ranks, scatter and
  gather).
- ``experts``: the expert products on local blocks (cannot: the
  einsum's placements), as two regions with the gate and up products'
  sum over a split D reduced between them.
- ``recurrence``: the Mamba scan on each rank's (batch, inner, state)
  block (cannot: an autograd function).
- ``embed``: the vocab-sharded table lookup as a Partial sum (cannot
  without gathering the table).
- ``matmul_f32``: the logits product into float32 (cannot:
  ``aten.mm.dtype`` has no strategy).
- ``logprob``: the target's log-probability, vocab-parallel where the
  vocabulary is split (slow, and it would gather the logits whole).
- ``topk_threshold``: the global top-k threshold of a gradient leaf on
  the gathered leaf (cannot: ``topk`` over a leaf split on two axes).
- ``sum_scalars``: the global grad norm's sum, reduced once a mesh dim
  (DTensor would reduce each leaf's Partial on its own).
"""
from __future__ import annotations

import functools
from functools import partial

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.api import local_region, place


def by_rule(rule):
    """Decorator: the function as written on plain tensors; where an
    argument (or a tensor in a list argument) is a DTensor,
    ``rule(fn, *args, **kwargs)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if any(isinstance(t, DTensor) for t in tree_flatten(args)[0]):
                return rule(fn, *args, **kwargs)
            return fn(*args, **kwargs)
        return run
    return wrap


def local_block(x, dim: int, placements=None) -> tuple:
    """(first index, length) along ``dim`` of this rank's block of DTensor
    ``x`` under ``placements`` (x's own by default): DTensor splits the
    mesh dims in order, the first one major."""
    mesh = x.device_mesh
    lo, n = 0, x.shape[dim]
    for i, p in enumerate(placements or x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n
    return lo, n


def keep_shards(x, dims) -> tuple:
    """x's placements with a ``Shard`` of a tensor dim in ``dims`` kept
    and every other placement (a ``Partial`` included) made
    ``Replicate``: the placements under which an operation independent
    along ``dims`` runs on local shards."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in x.placements)


def partial_where_sharded(placements) -> tuple:
    """``Partial`` on each mesh dim that ``placements`` shard, and
    ``Replicate`` elsewhere: the placements of a sum over the sharded
    dims that each rank takes over its own block."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in placements)


# ------------------------------------------------------------ attention

def sdpa(fn, q, k, v, mask, scale, *, split_rows=True, **kwargs):
    """Attention (``fn``: q (B,Sq,H,hd) with H = KV * G heads, k/v
    (B,Sk,KV,hd), ``mask`` broadcastable (B,1,1,Sq,Sk) or any other
    tensor with a row a sequence, ``kwargs`` static) on each rank's own
    sequences, heads and query rows (attention never mixes any of them).
    k and v keep their shards of the batch and the KV heads; q takes the
    same, the queries of a rank's KV heads.  On a mesh dim where the KV
    heads do not divide (so k and v arrive gathered) but q's H heads do,
    q keeps its own split, as GSPMD keeps ``wq``'s ("embed", "heads"):
    each rank computes only its own query heads, reading the KV heads
    they read from the gathered k and v (``_own_heads``).  On one where
    neither divides (whisper-base's 8 heads over 16 model ranks):

    - with at least a row a rank, q is split along its rows, each rank
      reading its rows of the mask, and the rows
      are gathered again after it (the products around attention stay
      as they are planned elsewhere).  Where the rows do not divide
      (1,500 encoder frames over 16 ranks), q is first padded to the
      next multiple with copies of its last row (and a plain mask's rows
      read past its end alike), so the blocks stay even (94 rows; the
      last rank's last 4 are padding), and the padding is cut after the
      gather: padding,
      not DTensor's uneven ``Shard``, because a local region gives its
      outputs the global shape of even blocks;
    - with fewer (a decode step's one row) but a whole number of ranks a
      head, each rank takes one head's slice of hd, as GSPMD splits the
      flat heads x hd: the head's scores whole, its slice of the output
      (``_own_head_slice``), gathered again after it.

    Neither applies without ``split_rows`` (the chunked schedules, whose
    loops take whole sequences and heads).
    k's and v's gradients are Partial sums on each such mesh dim.  The
    output lies as q does.  A mask with a row a sequence takes the
    rows' split.  Without gradients (serving), a cache split along its
    slots stays split: ``_sdpa_split_keys``, with q whole on those mesh
    dims."""
    mesh = k.device_mesh
    pk = keep_shards(k, (0, 1, 2))
    split = [i for i, p in enumerate(pk) if p == Shard(1) and mesh.size(i) > 1]
    if split and torch.is_grad_enabled():
        split = []
    if not split:
        pk = tuple(Replicate() if p == Shard(1) else p for p in pk)
    own = [i for i, (a, b) in enumerate(zip(pk, q.placements))
           if a == Replicate() and b == Shard(2)]
    Sq, H, hd = q.shape[1:]
    rows, m = [], 1
    for i, p in enumerate(pk):
        if split_rows and p == Replicate() and i not in own and \
                mesh.size(i) > 1 and Sq >= m * mesh.size(i):
            rows.append(i)
            m *= mesh.size(i)
    if Sq % m:  # padded to even blocks
        q = _resize_rows(q, 1, -(-Sq // m) * m)
    heads = [] if own or rows or split or not split_rows else [
        i for i, (a, b) in enumerate(zip(pk, q.placements))
        if a == b == Replicate() and mesh.size(i) > 1 and
        mesh.size(i) % H == 0 and hd % (mesh.size(i) // H) == 0][:1]
    pq = tuple(Shard(2) if i in own else Shard(1) if i in rows else
               Replicate() if p == Shard(1) else p for i, p in enumerate(pk))
    fn = partial(fn, scale=scale, **kwargs)
    if split:
        lo, n = local_block(k, 1, pk)
        fn = partial(_sdpa_split_keys, scale=scale, lo=lo, n=n,
                     groups=[(mesh, i) for i in split])
    if own:
        q_lo, _ = local_block(q, 2, pq)
        kv_lo, _ = local_block(k, 2, pk)
        G = q.shape[2] // k.shape[2]
        fn = partial(_own_heads, fn, lo=q_lo - kv_lo * G, G=G)
    po = pq
    if heads:  # this rank's block of the flat (B, Sq, H * hd)
        r, c = mesh.size(heads[0]) // H, mesh.get_local_rank(heads[0])
        fn = partial(_own_head_slice, fn, head=c // r, part=c % r, parts=r,
                     G=H // k.shape[2])
        po = tuple(Shard(2) if i in heads else p for i, p in enumerate(pq))
    pm = None  # a plain mask broadcasts over the rows
    if isinstance(mask, DTensor):
        r = mask.ndim - 2  # the mask's query rows
        pm = tuple(Shard(0) if p == Shard(0) and mask.shape[0] > 1 else
                   Shard(r) if p == Shard(1) and i in rows and
                   mask.shape[r] > 1 else Replicate()
                   for i, p in enumerate(pq))
    if rows and mask is not None and not isinstance(mask, DTensor) and \
            mask.shape[-2] > 1:
        lo, n = local_block(q, 1, pq)
        fn = partial(_own_rows, fn, lo=lo, n=n)
    grads = None
    if own or rows or heads:
        pg = tuple(Partial() if i in own + rows + heads else p
                   for i, p in enumerate(pk))
        gq = tuple(Partial() if i in heads else p for i, p in enumerate(pq))
        grads = (gq, pg, pg) + (() if mask is None else (pm,))
    if mask is None:
        out = local_region(lambda q_, k_, v_: fn(q_, k_, v_, None), po,
                           (pq, pk, pk), mesh, grads)(q, k, v)
    else:
        out = local_region(fn, po, (pq, pk, pk, pm), mesh, grads)(q, k, v,
                                                                  mask)
    if rows or heads:  # whole rows and heads again, as the output
        # projection expects them
        out = out.redistribute(mesh, tuple(
            Replicate() if i in rows + heads else p
            for i, p in enumerate(po)))
    if heads:
        out = out.unflatten(2, (H, hd))
    return out if out.shape[1] == Sq else _resize_rows(out, 1, Sq)


def _rows_to(t, dim: int, n: int):
    """``t`` with ``n`` rows along ``dim``: cut, or padded with copies of
    its last row (queries or mask rows like any other, whose results are
    cut again)."""
    if n <= t.shape[dim]:
        return t.narrow(dim, 0, n)
    size = list(t.shape)
    size[dim] = n - t.shape[dim]
    return torch.cat([t, t.narrow(dim, t.shape[dim] - 1, 1).expand(size)],
                     dim)


def _resize_rows(x, dim: int, n: int):
    """``_rows_to`` on DTensor ``x``, on each rank's block with ``dim``
    whole."""
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return local_region(partial(_rows_to, dim=dim, n=n), pl, (pl,),
                        x.device_mesh)(x)


def _own_rows(fn, q, k, v, mask, lo, n):
    """``fn`` on this rank's query rows ``lo`` .. ``lo + n - 1`` of the
    whole, with its rows of a plain mask that covers every row (past the
    mask's end, where the rows are padding, copies of its last row)."""
    return fn(q, k, v, _rows_to(mask, -2, lo + n)[..., lo:, :])


def _own_head_slice(fn, q, k, v, mask, head, part, parts, G):
    """``fn`` on query head ``head`` alone, reading KV head ``head // G``,
    and part ``part`` of ``parts`` of the values' width: the head's scores
    over its whole hd, the output's slice -> (B, Sq, hd / parts), this
    rank's block of the flat (B, Sq, H * hd)."""
    n = v.shape[-1] // parts
    kv = head // G
    out = fn(q[:, :, head:head + 1], k[:, :, kv:kv + 1],
             v[:, :, kv:kv + 1, part * n:(part + 1) * n], mask)
    return out.flatten(2)


def _own_heads(fn, q, k, v, mask, lo, G):
    """``fn`` on this rank's query heads, q (B,Sq,n,hd), heads ``lo`` ..
    ``lo + n - 1`` counted from the first of the KV heads in k and v
    (B,Sk,KV,hd), of which head h reads KV head h // G: k and v are cut
    to the KV heads the n queries read (one, or whole groups of G), or,
    where the queries straddle groups unevenly, each query's KV head is
    taken on its own."""
    n = q.shape[2]
    a, b = lo // G, (lo + n - 1) // G + 1
    if b - a == 1 or (lo % G == 0 and n == (b - a) * G):
        k, v = k[:, :, a:b], v[:, :, a:b]
    else:
        idx = torch.arange(lo, lo + n, device=k.device) // G
        k, v = k[:, :, idx], v[:, :, idx]
    return fn(q, k, v, mask)


def _sdpa_split_keys(q, k, v, mask, scale, lo, n, groups):
    """Plain attention over keys ``lo .. lo + n`` of the whole (this
    rank's block of a cache split along its slots; ``mask`` covers every
    slot): the scores' max and the exponentials' sum are reduced over
    the ``groups`` that split the slots, so each rank holds its keys'
    share of the softmax, cast to the values' type as the plain path
    casts it; the weighted values are then summed over the groups in
    float32, flash-decoding across ranks.  Forward only."""
    from torch.distributed._functional_collectives import all_reduce
    q = q.unflatten(2, (k.shape[2], -1))
    scores = torch.einsum("bqcgh,bkch->bcgqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[..., lo:lo + n], -1e30)
    m = torch.amax(scores, dim=-1, keepdim=True)
    for g in groups:
        m = all_reduce(m, "max", g)
    p = torch.exp(scores - m)
    total = torch.sum(p, dim=-1, keepdim=True)
    for g in groups:
        total = all_reduce(total, "sum", g)
    out = torch.einsum("bcgqk,bkch->bqcgh", (p / total).to(v.dtype),
                       v).float()
    for g in groups:
        out = all_reduce(out, "sum", g)
    return out.to(v.dtype).flatten(2, 3)


def write_slots(fn, cache, slot, new):
    """``cache[b, slot[b]] = new[b]`` in place on a DTensor cache: each
    rank writes the rows of its own block of sequences and slots
    (GSPMD's partitioned scatter); ``new`` and ``slot`` are placed as the
    cache's rows and heads, and a slot outside the rank's block rewrites
    the value already there."""
    mesh, pc = cache.device_mesh, cache.placements
    pn = tuple(Shard(q.dim - 1) if isinstance(q, Shard) and q.dim >= 2 else
               q if isinstance(q, Shard) and q.dim == 0 else Replicate()
               for q in pc)
    ps = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
               for q in pc)
    new_l = new.redistribute(mesh, pn).to_local().to(cache.dtype)
    slot_l = slot.redistribute(mesh, ps).to_local()
    lo, n = local_block(cache, 1)
    c = cache.to_local()
    owned = (slot_l >= lo) & (slot_l < lo + n)
    idx = torch.where(owned, slot_l - lo, 0)
    bidx = torch.arange(c.shape[0], device=c.device)
    c[bidx, idx] = torch.where(owned[:, None, None], new_l, c[bidx, idx])


# ------------------------------------------------------------ MoE, Mamba

def per_sequence(*out_placements):
    """A rule that runs ``fn`` over each rank's own sequences: the batch
    dim of the first argument keeps its shards and every other dim is
    gathered, and every DTensor argument takes the same placements, so
    their local rows are the same sequences.  ``out_placements`` maps
    the batch placements to each output's (None, or none given: the
    batch's)."""
    def rule(fn, *args, **kwargs):
        pl = keep_shards(args[0], (0,))
        ins = tuple(pl if isinstance(a, DTensor) else None for a in args)
        outs = tuple(pl if o is None else o(pl) for o in out_placements)
        return local_region(partial(fn, **kwargs),
                            outs if len(outs) > 1 else outs[0] if outs
                            else pl, ins, args[0].device_mesh)(*args)
    return rule


# what each kind of mesh dim splits in the expert products: the buffer,
# w_gate and w_up, the gate and up products g and u, w_down, the output
_EXPERT_LAYOUT = {
    "rows": (Shard(0), Replicate(), Shard(0), Replicate(), Shard(0)),
    "experts": (Shard(1), Shard(0), Shard(1), Shard(0), Shard(1)),
    "ffn": (Replicate(), Shard(2), Shard(3), Shard(1), Partial()),
    "embed": (Shard(3), Shard(1), Partial(), Shard(2), Shard(3)),
    None: (Replicate(),) * 5,
}


def _expert_kinds(buf, w_gate, w_down) -> list:
    """The kind of each mesh dim for the expert products (keys of
    ``_EXPERT_LAYOUT``): "rows" where it splits the buffer's batch,
    "experts" where it splits its experts; else, as the weights lie
    there, "ffn" (the expert FFN dim) or "embed" (their FSDP shard of
    D).  A dim of more than one rank where the weights are whole (the
    "pod" axis at batch 1) splits the experts, or else the FFN dim,
    where no other dim splits it: a block of a whole weight is a local
    slice, where a block across another dim's split would move it."""
    mesh = buf.device_mesh
    kinds = []
    for b, w, d in zip(keep_shards(buf, (0, 1)), w_gate.placements,
                       w_down.placements):
        kinds.append("rows" if b == Shard(0) else
                     "experts" if b == Shard(1) else
                     "ffn" if w == Shard(2) else
                     "embed" if w == Shard(1) and d == Shard(2) else None)
    sizes = {"experts": w_gate.shape[0], "ffn": w_gate.shape[2]}
    for i, (k, w) in enumerate(zip(kinds, w_gate.placements)):
        if k is None and w == Replicate() and mesh.size(i) > 1:
            kinds[i] = next((kind for kind, n in sizes.items()
                             if kind not in kinds and n % mesh.size(i) == 0),
                            None)
    return kinds


def experts(up, down):
    """A rule for the expert products, ``up`` (buf, w_gate, w_up) -> (g,
    u) then ``down`` (g, u, w_down) -> out, each on local blocks, laid out
    as the reference's constraints and GSPMD place them, a mesh dim at a
    time (``_expert_kinds``): where it splits the buffer's batch, the
    weights are gathered and their gradients are Partial sums; where it
    splits the experts, the weights are split alike; where the weights
    keep a split of the expert FFN dim, so do g and u, and the output
    (and the buffer's gradient) is a Partial sum; where they keep their
    FSDP "embed" shard of D (at batch 1), each rank takes its block of
    the buffer's D columns, g and u are Partial sums, reduced before the
    SiLU, and the output lies split along D (the buffer's gradient too).
    An input that is whole where the others are split has a Partial
    gradient there."""
    def rule(fn, buf, w_gate, w_up, w_down):
        mesh = buf.device_mesh
        kinds = _expert_kinds(buf, w_gate, w_down)
        pb, pw, pg, pd, out = (tuple(_EXPERT_LAYOUT[k][j] for k in kinds)
                               for j in range(5))

        def grad(pl):
            return tuple(Partial() if k and p == Replicate() else p
                         for k, p in zip(kinds, pl))

        g, u = local_region(up, (pg, pg), (pb, pw, pw), mesh,
                            (grad(pb), grad(pw), grad(pw)))(buf, w_gate, w_up)
        pg = tuple(Replicate() if isinstance(p, Partial) else p for p in pg)
        g, u = g.redistribute(mesh, pg), u.redistribute(mesh, pg)
        return local_region(down, out, (pg, pg, pd), mesh,
                            (grad(pg), grad(pg), grad(pd)))(g, u, w_down)
    return rule


def recurrence(fn, h0, a, b):
    """The scan ``fn`` on each rank's own block of (batch, inner, state),
    which the recurrence along the chunk never crosses (a shard of the
    chunk's positions, or a Partial, is gathered first)."""
    pl = keep_shards(b, (0, 2, 3))
    ph = tuple(Shard(q.dim - 1) if isinstance(q, Shard) and q.dim else q
               for q in pl)
    if not isinstance(h0, DTensor):
        h0 = place(h0, b.device_mesh, ph)
    # ``b`` is written over in place: the local region takes a copy, as
    # a view that DTensor hands out cannot be marked dirty
    return local_region(lambda h, a_, b_: fn(h, a_, b_.clone()),
                        pl, (ph, pl, pl), b.device_mesh)(h0, a, b)


# ------------------------------------------------------- embedding, logits

def _lookup(table, tokens, lo: int):
    """Rows ``tokens - lo`` of a block of the table that starts at row
    ``lo``; a token outside the block reads zeros."""
    out_of_block = (tokens < lo) | (tokens >= lo + table.shape[0])
    rows = table[torch.where(out_of_block, 0, tokens - lo)]
    return torch.where(out_of_block[..., None], torch.zeros_like(rows), rows)


def embed(fn, table, tokens):
    """``table[tokens]`` as GSPMD partitions a gather from a vocab-sharded
    table: each rank reads its own block of the vocabulary for its own
    rows of tokens (zeros for tokens outside the block), and the result
    is a Partial sum over the mesh dims that split the vocabulary; the
    table's other splits are gathered."""
    pk = keep_shards(tokens, tuple(range(tokens.ndim)))
    pt = tuple(Replicate() if isinstance(a, Shard) else b
               for a, b in zip(pk, keep_shards(table, (0,))))
    lo, _ = local_block(table, 0, pt)
    out = tuple(Partial() if isinstance(b, Shard) else a
                for a, b in zip(pk, pt))
    grad = tuple(Partial() if isinstance(a, Shard) else b
                 for a, b in zip(pk, pt))
    return local_region(partial(_lookup, lo=lo), out, (pt, pk),
                        table.device_mesh, (grad, pk))(table, tokens)


def matmul_f32(fn, h2, table):
    """``fn`` (h2 @ table.T into float32) on local blocks with the
    placements GSPMD gives vocab-sharded logits: the rows keep their
    batch shards, the table its vocab shards on the mesh dims the rows
    do not use, and whatever else either is split over (the table's FSDP
    "embed" shard, a Partial) is gathered.  The logits are then sharded
    as the rows on dim 0 and as the table on dim 1; each operand's
    gradient is a Partial sum on the mesh dims that split the other."""
    ph = keep_shards(h2, (0,))
    pt = tuple(Replicate() if isinstance(a, Shard) else b
               for a, b in zip(ph, keep_shards(table, (0,))))
    out = tuple(Shard(0) if isinstance(a, Shard) else
                Shard(1) if isinstance(b, Shard) else Replicate()
                for a, b in zip(ph, pt))
    grads = (tuple(Partial() if isinstance(b, Shard) else a
                   for a, b in zip(ph, pt)),
             tuple(Partial() if isinstance(a, Shard) else b
                   for a, b in zip(ph, pt)))
    return local_region(fn, out, (ph, pt), h2.device_mesh, grads)(h2, table)


def logprob(fn, logits, t):
    """Each position's log-probability of its target (``fn``) on each
    rank's rows, and where the vocabulary is split, vocab-parallel
    (``_VocabParallelLogprob``), so neither the logits nor their
    gradient is ever gathered whole."""
    pl = keep_shards(logits, (0, 2))
    prow = tuple(p if p == Shard(0) else Replicate() for p in pl)
    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(pl)
             if p == Shard(2) and mesh.size(i) > 1]
    if not vocab:
        return local_region(fn, prow, (pl, prow), mesh)(logits, t)
    lo, _ = local_block(logits, 2, pl)
    groups = [(mesh, i) for i in vocab]
    run = lambda x, y: _VocabParallelLogprob.apply(x, y, lo, groups)  # noqa
    return local_region(run, prow, (pl, prow), mesh)(logits, t)


class _VocabParallelLogprob(torch.autograd.Function):
    """log_softmax(x)[..., t] of local logits (..., V_local), a block of
    the vocabulary that starts at ``lo``, with the all-reduces over the
    mesh dims that split the vocabulary (Megatron's vocab-parallel cross
    entropy): the max, the sum of exponentials and the target's logit.
    The gradient, (one-hot of the target - softmax) times the incoming
    one, is computed on the block, with no communication."""

    @staticmethod
    def forward(ctx, x, t, lo, groups):
        from torch.distributed._functional_collectives import all_reduce
        m = torch.amax(x, dim=-1, keepdim=True)
        for g in groups:
            m = all_reduce(m, "max", g)
        z = x - m
        e = torch.exp(z)
        se = torch.sum(e, dim=-1, keepdim=True)
        for g in groups:
            se = all_reduce(se, "sum", g)
        inb = (t >= lo) & (t < lo + x.shape[-1])
        idx = torch.where(inb, t - lo, 0)[..., None]
        tz = torch.where(inb, torch.gather(z, -1, idx)[..., 0], 0.0)
        for g in groups:
            tz = all_reduce(tz, "sum", g)
        ctx.save_for_backward(e, se, idx, inb)
        return tz - torch.log(se[..., 0])

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inb = ctx.saved_tensors
        grad = -(e / se) * g[..., None]
        grad.scatter_add_(-1, idx, torch.where(inb, g, 0.0)[..., None])
        return grad, None, None, None


# ------------------------------------------------------------ training

def topk_threshold(fn, g, *args):
    """``fn``'s threshold of the whole leaf: a global top-k, as GSPMD
    computes it, on the gathered leaf; replicated on its mesh."""
    mesh = g.device_mesh
    return DTensor.from_local(fn(g.full_tensor(), *args), mesh,
                              [Replicate()] * mesh.ndim)


def _reduced_once(fn, scalars):
    """``fn`` (a sum) of scalars, some of them DTensors: each rank adds up
    its own share of each (a Partial's local value; a replicated one's
    on the first rank of each mesh dim that replicates it, 0 on the
    others), in the same order, and the total is reduced once: one
    all-reduce of a scalar for each mesh dim."""
    mesh = next(s for s in scalars if isinstance(s, DTensor)).device_mesh
    total = DTensor.from_local(
        fn([_own_share(s, mesh) for s in scalars]), mesh,
        [Partial()] * mesh.ndim)
    return total.redistribute(mesh, [Replicate()] * mesh.ndim)


@by_rule(_reduced_once)
def sum_scalars(scalars):
    """The sum of a list of scalars, in order (the grad norm's)."""
    return torch.sum(torch.stack(scalars))


def _own_share(s, mesh) -> torch.Tensor:
    """This rank's addend of scalar ``s`` in a sum over every rank."""
    if not isinstance(s, DTensor):
        s = DTensor.from_local(s, mesh, [Replicate()] * mesh.ndim)
    local = s.to_local()
    for i, p in enumerate(s.placements):
        if not isinstance(p, Partial) and mesh.get_local_rank(i) != 0:
            local = torch.zeros_like(local)
    return local
