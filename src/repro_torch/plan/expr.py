"""Expression AST over natural-language semantic predicates.

A query is a boolean tree whose leaves are ``Pred`` nodes — each binds one
predicate to the oracle that answers it (plus optional per-predicate CSV
config overrides).  ``And`` / ``Or`` / ``Not`` compose them; the operators
``&``, ``|``, ``~`` build the tree inline:

    expr = Pred("positive review", o1) & ~Pred("mentions price", o2)

The AST is *logical*: it fixes semantics, not evaluation order.  The
optimizer (``repro_torch.plan.optimizer``) lowers it to a physical cascade by
reordering the children of every And/Or node; the executor
(``repro_torch.plan.executor``) evaluates leaves on shrinking live subsets.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


class Expr:
    """Base node.  Supports ``&``, ``|``, ``~`` composition."""

    def __and__(self, other: "Expr") -> "And":
        return And(self, other)

    def __or__(self, other: "Expr") -> "Or":
        return Or(self, other)

    def __invert__(self) -> "Not":
        return Not(self)

    def leaves(self) -> list["Pred"]:
        """All Pred leaves in left-to-right (naive evaluation) order."""
        raise NotImplementedError

    @property
    def label(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass
class Pred(Expr):
    """One natural-language predicate bound to its oracle.

    name: unique identifier (used by the cost model's pilot table and in
    ``PlanResult.order``).
    oracle: callable(ids) -> bool array with ``.stats``
    (repro_torch.core.oracle).
    cfg: optional per-predicate ``CSVConfig`` override (e.g. a SimVote
    predicate inside a UniVote plan); None inherits the executor default.
    """
    name: str
    oracle: Any
    cfg: Optional[Any] = None

    def leaves(self) -> list["Pred"]:
        return [self]

    @property
    def label(self) -> str:
        return self.name


class _Nary(Expr):
    """Shared And/Or machinery: flattens nested same-type nodes."""

    _op = "?"

    def __init__(self, *children: Expr):
        flat: list[Expr] = []
        for c in children:
            if not isinstance(c, Expr):
                raise TypeError(f"expected Expr, got {type(c).__name__}")
            if type(c) is type(self):
                flat.extend(c.children)  # (a & b) & c == And(a, b, c)
            else:
                flat.append(c)
        if len(flat) < 1:
            raise ValueError(f"{type(self).__name__} needs >= 1 child")
        self.children: tuple[Expr, ...] = tuple(flat)

    def leaves(self) -> list[Pred]:
        return [leaf for c in self.children for leaf in c.leaves()]

    @property
    def label(self) -> str:
        inner = f" {self._op} ".join(c.label for c in self.children)
        return f"({inner})"

    def __repr__(self):
        return self.label


class And(_Nary):
    """All children must hold; evaluated as a short-circuit cascade."""
    _op = "AND"


class Or(_Nary):
    """Any child suffices; children only see tuples not yet accepted."""
    _op = "OR"


class Not(Expr):
    def __init__(self, child: Expr):
        if not isinstance(child, Expr):
            raise TypeError(f"expected Expr, got {type(child).__name__}")
        self.child = child

    def leaves(self) -> list[Pred]:
        return self.child.leaves()

    @property
    def label(self) -> str:
        return f"NOT {self.child.label}"

    def __repr__(self):
        return self.label


def needs_ordering(expr: Expr) -> bool:
    """True iff some And/Or node has >= 2 children — i.e. a pilot pass can
    actually change the evaluation order.  A bare Pred (or a pure Not chain)
    has a unique order, so the executor skips the pilot entirely and stays
    bit-identical to ``sem_filter``."""
    if isinstance(expr, _Nary):
        if len(expr.children) >= 2:
            return True
        return any(needs_ordering(c) for c in expr.children)
    if isinstance(expr, Not):
        return needs_ordering(expr.child)
    return False
