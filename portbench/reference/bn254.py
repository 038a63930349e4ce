"""BN254 G1 arithmetic on the host (affine, Python ints; infinity = None).

Frozen copy of the G1 part of ``zerog_tpu_torch/curve/bn254.py``, taken
when the benchmark was defined; the pairing is not needed here, since the
reference knows the SRS trapdoor tau.
"""

from __future__ import annotations

from .field import FQ, FR

P = FQ.p
R_ORDER = FR.p

B_G1 = 3

G1_GEN = (1, 2)


# ---------------------------------------------------------------------------
# G1 (affine over Fq, Python ints). Infinity = None.
# ---------------------------------------------------------------------------

def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_G1) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    k %= R_ORDER
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc
