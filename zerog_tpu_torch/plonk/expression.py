"""Polynomial-constraint expression IR.

Counterpart of `halo2_proofs::plonk::Expression` (registered via
`meta.create_gate`/`meta.lookup` throughout reference src/gadgets/). An
expression is a small tree over column queries at rotations; it is *compiled*
once and then evaluated over whole columns at once — on host ints (MockProver,
verifier at a point) or on device Montgomery limb arrays (quotient evaluation
over the extended coset domain), via a pluggable ops object.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "Expr", "Constant", "FixedQuery", "AdviceQuery", "InstanceQuery",
    "Sum", "Product", "Scaled", "evaluate", "degree", "collect_queries",
]


class Expr:
    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Scaled(_lift(other), -1))

    def __rsub__(self, other):
        return Sum(_lift(other), Scaled(self, -1))

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return Product(self, _lift(other))

    def __rmul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return Product(_lift(other), self)

    def __neg__(self):
        return Scaled(self, -1)


def _lift(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Constant(x)
    raise TypeError(f"cannot lift {type(x)} to Expr")


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    value: int


@dataclasses.dataclass(frozen=True)
class FixedQuery(Expr):
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class AdviceQuery(Expr):
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class InstanceQuery(Expr):
    column: int
    rotation: int = 0


@dataclasses.dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Product(Expr):
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Scaled(Expr):
    a: Expr
    scalar: int


def degree(e: Expr) -> int:
    if isinstance(e, Constant):
        return 0
    if isinstance(e, (FixedQuery, AdviceQuery, InstanceQuery)):
        return 1
    if isinstance(e, Sum):
        return max(degree(e.a), degree(e.b))
    if isinstance(e, Product):
        return degree(e.a) + degree(e.b)
    if isinstance(e, Scaled):
        return degree(e.a)
    raise TypeError(e)


def collect_queries(e: Expr, out: set | None = None) -> set:
    """All (kind, column, rotation) triples appearing in the expression."""
    if out is None:
        out = set()
    if isinstance(e, FixedQuery):
        out.add(("fixed", e.column, e.rotation))
    elif isinstance(e, AdviceQuery):
        out.add(("advice", e.column, e.rotation))
    elif isinstance(e, InstanceQuery):
        out.add(("instance", e.column, e.rotation))
    elif isinstance(e, (Sum, Product)):
        collect_queries(e.a, out)
        collect_queries(e.b, out)
    elif isinstance(e, Scaled):
        collect_queries(e.a, out)
    return out


def evaluate(e: Expr, ops: Any, memo: "dict[bytes, Any] | None" = None):
    """Evaluate with an ops object providing:
    constant(int), fixed(col, rot), advice(col, rot), instance(col, rot),
    add(a, b), mul(a, b), scale(a, int).
    Shared subtrees are cached by identity. Passing a `memo` dict additionally
    caches composite nodes by STRUCTURE (canonical_bytes) — and persists
    across evaluate() calls sharing the dict — so structurally repeated
    subtrees (e.g. the interpolation polynomial of a compressed selector,
    rebuilt per query site) are computed once. Only sound when the ops
    values for equal leaves are stable for the memo's lifetime."""
    cache: dict[int, Any] = {}

    def go(node: Expr):
        key = id(node)
        if key in cache:
            return cache[key]
        skey = None
        if memo is not None and isinstance(node, (Sum, Product, Scaled)):
            skey = canonical_bytes(node)
            hit = memo.get(skey)
            if hit is not None:
                cache[key] = hit
                return hit
        if isinstance(node, Constant):
            v = ops.constant(node.value)
        elif isinstance(node, FixedQuery):
            v = ops.fixed(node.column, node.rotation)
        elif isinstance(node, AdviceQuery):
            v = ops.advice(node.column, node.rotation)
        elif isinstance(node, InstanceQuery):
            v = ops.instance(node.column, node.rotation)
        elif isinstance(node, Sum):
            v = ops.add(go(node.a), go(node.b))
        elif isinstance(node, Product):
            v = ops.mul(go(node.a), go(node.b))
        elif isinstance(node, Scaled):
            v = ops.scale(go(node.a), node.scalar)
        else:
            raise TypeError(node)
        cache[key] = v
        if skey is not None:
            memo[skey] = v
        return v

    try:
        return go(e)
    finally:
        # go's closure refers to go itself, a cycle that would keep every
        # value in cache alive until the cyclic collector runs
        cache.clear()


def canonical_bytes(e: Expr) -> bytes:
    """Stable byte encoding of an expression tree for key digests (unlike
    repr(), immune to dataclass/__repr__ formatting changes)."""
    if isinstance(e, Constant):
        return b"C" + str(e.value).encode()
    if isinstance(e, FixedQuery):
        return b"F%d:%d" % (e.column, e.rotation)
    if isinstance(e, AdviceQuery):
        return b"A%d:%d" % (e.column, e.rotation)
    if isinstance(e, InstanceQuery):
        return b"I%d:%d" % (e.column, e.rotation)
    if isinstance(e, Sum):
        return b"S(" + canonical_bytes(e.a) + b"," + canonical_bytes(e.b) + b")"
    if isinstance(e, Product):
        return b"P(" + canonical_bytes(e.a) + b"," + canonical_bytes(e.b) + b")"
    if isinstance(e, Scaled):
        return b"X(" + canonical_bytes(e.a) + b"," + str(e.scalar).encode() + b")"
    raise TypeError(e)
