"""Tree helpers over nested dicts, lists and tuples of tensors.

The port's parameter, optimizer and checkpoint trees are plain
containers.  Every helper visits leaves in the reference's
``jax.tree_util`` order: dict keys sorted, list and tuple items by
index, ``None`` an empty subtree.  A leaf's path string is its keys and
indices joined by ``/`` (``blocks/0/l0/attn/wq``), as the reference's
``_path_str``.  A DTensor is a leaf like any tensor.
"""
from __future__ import annotations

import math

import torch


def tree_leaves_with_path(tree, is_leaf=None, prefix=()) -> list:
    """``(path string, leaf)`` pairs in the reference's leaf order.

    ``is_leaf(x)`` may stop the descent at a container (a tuple of axis
    names, say)."""
    if tree is None:
        return []
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return [kv for k in sorted(tree)
                    for kv in tree_leaves_with_path(tree[k], is_leaf,
                                                    prefix + (k,))]
        if isinstance(tree, (list, tuple)):
            return [kv for i, sub in enumerate(tree)
                    for kv in tree_leaves_with_path(sub, is_leaf,
                                                    prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def tree_leaves(tree, is_leaf=None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``tree`` with each leaf replaced by ``fn(leaf, *leaves of rest)``;
    the trees in ``rest`` have ``tree``'s structure.  Leaves are visited
    in the reference's order."""
    if tree is None:
        return None
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                                is_leaf=is_leaf) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(
                tree_map(fn, sub, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, sub in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path_str(fn, tree, is_leaf=None):
    """tree_map where fn receives (path_string, leaf)."""
    paths = iter(p for p, _ in tree_leaves_with_path(tree, is_leaf))
    return tree_map(lambda leaf: fn(next(paths), leaf), tree,
                    is_leaf=is_leaf)


def tree_param_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves (meta tensors included)."""
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's float32 sum of squares; on
    DTensor leaves the sum is ``distributed.partition.sum_scalars``'s,
    reduced once."""
    from repro_torch.distributed.partition import sum_scalars  # imports us
    return torch.sqrt(sum_scalars([torch.sum(torch.square(x.float()))
                                   for x in tree_leaves(tree)]))
