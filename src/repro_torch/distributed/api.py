"""Sharding-context API.

Model code may annotate activations with *logical* axis names via
``shard_act``.  When a ``sharding_context`` is active (the launcher and
the dry run install one), the names resolve through the mesh rules, as
the reference's do, and any rule that does not fit is recorded in the
rules' ``warnings``.  The port runs on one card, so the resolved spec
constrains nothing: ``shard_act`` returns ``x`` itself, inside a context
or not.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


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
    """Resolve activation x's logical axis names against the active
    MeshRules (recording its warnings) and return x unchanged.

    ``logical_axes`` length must equal x.ndim; entries are logical names
    or None.  No-op when no sharding context is active.
    """
    rules = current_rules()
    if rules is not None:
        rules.activation_spec(logical_axes, x.shape)
    return x
