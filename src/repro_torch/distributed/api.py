"""Sharding-context API: placements, constraints, and local regions.

Model code annotates activations with *logical* axis names via
``shard_act``.  When a ``sharding_context`` is active (the launcher and
the dry run install one), the names resolve through the mesh rules, as
the reference's do.  Where the rules' mesh stands over a ``DeviceMesh``
and ``x`` is a ``DTensor``, ``shard_act`` redistributes ``x`` to the
resolved placements: the counterpart of ``with_sharding_constraint``,
issuing the collectives that change needs (a ``Partial`` is reduced, a
shard gathered).  A plain tensor passes through unchanged, inside a
context or not, so the same model code runs on one card and partitioned.

``distribute_tree`` places a tree by its logical axes (the reference's
``in_shardings``), ``gather_tree`` makes every leaf whole again, and
``local_region`` runs a function on each rank's local shards with stated
placements (``local_map``): ``distributed.partition`` holds the rules
that use it, one for each operation DTensor cannot propagate.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)

from repro_torch.utils.tree import tree_leaves, tree_map

_state = threading.local()

_is_axes = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_context(rules):
    """rules: a MeshRules instance (see repro_torch.distributed.rules)."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def shard_act(x, logical_axes: tuple):
    """Constrain activation x to the placements its logical axis names
    resolve to under the active MeshRules (recording the rules'
    warnings).

    ``logical_axes`` length must equal x.ndim; entries are logical names
    or None (replicated).  A plain tensor, or a context whose mesh has no
    ``DeviceMesh``, returns x itself; no context is a no-op.
    """
    rules = current_rules()
    if rules is None:
        return x
    spec = rules.activation_spec(logical_axes, x.shape)
    dm = getattr(rules.mesh, "device_mesh", None)
    if dm is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(dm, rules.placements(spec))


def place(t, device_mesh, placements):
    """``t`` as a DTensor on ``device_mesh`` with ``placements``: each rank
    keeps its own block of its full copy (every rank holds the same
    tensor, so nothing is broadcast); a DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(t, DTensor):
        return t.redistribute(device_mesh, placements)
    return distribute_tensor(t, device_mesh, placements, src_data_rank=None)


def distribute_tree(tree, axes_tree, rules):
    """Every leaf of ``tree`` placed on the rules' ``DeviceMesh`` by its
    logical axes in ``axes_tree`` (a tree of axis-name tuples of
    ``tree``'s structure)."""
    dm = rules.mesh.device_mesh
    if dm is None:
        raise ValueError(f"mesh {rules.mesh.shape} has no DeviceMesh to "
                         "place tensors on")
    return tree_map(
        lambda ax, t: place(t, dm, rules.placements(
            rules.spec(ax, tuple(t.shape)))),
        axes_tree, tree, is_leaf=_is_axes)


def tree_placements(tree, axes_tree, rules):
    """``(DeviceMesh, placements)`` for every leaf of ``tree`` by its
    logical axes: the ``shardings`` tree of a checkpoint restore."""
    dm = rules.mesh.device_mesh
    return tree_map(
        lambda ax, t: (dm, rules.placements(rules.spec(ax, tuple(t.shape)))),
        axes_tree, tree, is_leaf=_is_axes)


def gather_tree(tree):
    """Every DTensor leaf made whole (``full_tensor()``); plain leaves as
    they are."""
    return tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def partitioned(tree):
    """A context for a program over ``tree``: where a leaf is a DTensor,
    the plain tensors the program makes (positions, masks, zero
    accumulators) count as replicated on its mesh
    (``implicit_replication``); otherwise nothing."""
    from torch.distributed.tensor.experimental import implicit_replication
    if any(isinstance(t, DTensor) for t in tree_leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def split_dim(x, dim: int, sizes: tuple):
    """``x.unflatten(dim, sizes)``.  DTensor can split a sharded dim only
    where the first of ``sizes`` divides into the shards, so a DTensor
    first gathers the mesh dims that split ``dim`` beyond what
    ``sizes[0]`` takes, the minor ones first.  The attention splits q
    into its H heads alone, never into (KV, G) groups, so q stays split
    wherever its heads divide the model axis; k and v, split into their
    KV heads, are gathered where those do not (8 KV heads over 16 model
    ranks), and ``partition.sdpa`` reads from them only the KV heads
    each rank's queries read."""
    if isinstance(x, DTensor):
        d = dim % x.ndim
        lead = sizes[0] if sizes[0] != -1 else x.shape[d] // math.prod(
            sizes[1:])
        pl, n = list(x.placements), 1
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == d:
                if lead % (n * x.device_mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    n *= x.device_mesh.size(i)
        if tuple(pl) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.unflatten(dim, sizes)


def merge_heads(x, w):
    """``x.flatten(2)``: (B, S, heads..., hd) -> (B, S, heads * hd).  On a
    DTensor, in a local region, so that the gradient, which comes back
    split over the merged dim however the next product splits it, is
    first placed as the heads are (DTensor cannot split it back into
    heads where their count does not divide into its shards).  Where the
    merged heads are whole on a mesh dim that splits the rows of ``w``
    (the weight of the product that follows, ``x @ w``), they are then
    split alike, a local slice whose gradient is gathered as DTensor
    would gather it for the product: the product saves the block, so
    the backward computes ``w``'s gradient on it, where DTensor's
    planner, which weighs collectives and not FLOPs, would compute it
    whole on every rank from the whole ``x`` (whisper-base's 8 heads,
    gathered over 16 model ranks)."""
    if not isinstance(x, DTensor):
        return x.flatten(2)
    pin = tuple(Replicate() if isinstance(p, Shard) and p.dim > 2 else p
                for p in x.placements)
    pout = tuple(Shard(p.dim if p.dim < 2 else 2) if isinstance(p, Shard)
                 else p for p in pin)
    grad = tuple(Replicate() if isinstance(p, Partial) else p for p in pin)
    out = local_region(lambda t: t.flatten(2), pout, (pin,), x.device_mesh,
                       (grad,))(x)
    pl = tuple(Shard(2) if a == Replicate() and b == Shard(0) else a
               for a, b in zip(out.placements, w.placements))
    return out if pl == tuple(out.placements) else out.redistribute(
        x.device_mesh, pl)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_region(fn, out_placements, in_placements, device_mesh,
                 in_grad_placements=None):
    """``fn`` over the local shards of its DTensor arguments, each first
    redistributed to its ``in_placements``; the outputs come back as
    DTensors with ``out_placements`` (``local_map``).  A non-tensor
    argument or output takes None.  ``in_grad_placements`` states an
    input's gradient placements where they are not its own (a
    replicated weight multiplied by sharded rows has a ``Partial``
    gradient).  On a mesh of more than one rank the inputs' local
    gradients leave the region contiguous: DTensor views a local gradient
    as it would the global one, and a block of a transposed layout (an
    einsum's backward gives them) cannot be viewed so.  On one rank the
    block is the whole tensor and keeps its layout, so the same kernels
    run as on a plain tensor."""
    from torch.distributed.tensor.experimental import local_map

    def norm(pl):  # one tensor's placements, as local_map takes them
        return None if pl is None else list(pl)

    def run(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))

    if device_mesh.size() == 1:  # blocks are the whole: views hold
        run = fn

    if all(isinstance(p, Placement) for p in out_placements):
        outs = norm(out_placements)  # one output
    else:
        outs = tuple(norm(p) for p in out_placements)
    return local_map(
        run, out_placements=outs,
        in_placements=tuple(norm(p) for p in in_placements),
        in_grad_placements=None if in_grad_placements is None else tuple(
            norm(p) for p in in_grad_placements),
        device_mesh=device_mesh, redistribute_inputs=True)
