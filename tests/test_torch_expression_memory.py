"""``plonk.expression.evaluate`` frees the values of its subtrees when it
returns, without waiting for Python's cyclic collector: on the card each is
a whole extended-domain column (128 MiB at 2^20 rows), and the quotient
evaluates one expression a gate."""

import gc
import weakref

import torch

from zerog_tpu_torch.plonk.expression import AdviceQuery, Product, Sum, evaluate

torch.set_num_threads(1)


class _Ops:
    """Tensor leaves; every value a node makes is watched by a weak
    reference."""

    def __init__(self):
        self.made = []

    def _watch(self, t):
        self.made.append(weakref.ref(t))
        return t

    def advice(self, col, rot):
        return torch.full((4,), float(col + 1))

    def add(self, a, b):
        return self._watch(a + b)

    def mul(self, a, b):
        return self._watch(a * b)


def _expr():
    q = [AdviceQuery(i, 0) for i in range(4)]
    shared = Product(q[0], q[1])
    return Sum(Sum(shared, Product(q[2], q[3])), shared)


def test_evaluate_frees_its_intermediates_at_return():
    enabled = gc.isenabled()
    gc.disable()
    try:
        ops = _Ops()
        out = evaluate(_expr(), ops)
        assert out.tolist() == [2 + 12 + 2] * 4
        alive = [r() for r in ops.made if r() is not None]
        assert len(alive) == 1 and alive[0] is out
    finally:
        if enabled:
            gc.enable()


def test_evaluate_keeps_what_its_memo_holds():
    enabled = gc.isenabled()
    gc.disable()
    try:
        ops = _Ops()
        memo = {}
        out = evaluate(_expr(), ops, memo)
        alive = {id(r()) for r in ops.made if r() is not None}
        assert alive == {id(v) for v in memo.values()} | {id(out)}
        assert len(alive) == 4      # the three distinct composite nodes and the root
    finally:
        if enabled:
            gc.enable()
