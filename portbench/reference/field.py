"""BN254 field parameters and host-side (Python int) modular arithmetic helpers.

The framework works over the two prime fields of the BN254 ("bn256") pairing
curve, matching the reference prover's choice of `halo2curves::bn256::{Fr, Fq}`
(reference: src/wnn.rs:18).

- ``FR``: the scalar field (circuit values, polynomials, KZG scalars).
- ``FQ``: the base field (G1/G2 coordinates).

Device-side representation (the program's tensor field):
little-endian arrays of 16 limbs x 16 bits in the last axis, values kept in
Montgomery form (R = 2^256).

Host-side representation: plain Python ints in ``[0, p)`` — used for witness
generation, transcripts and anything sequential/small.

Frozen copy of ``zerog_tpu_torch/field/params.py``, taken when the benchmark was
defined; only its imports differ.
"""

from __future__ import annotations

import dataclasses

__all__ = ["FieldParams", "FR", "FQ", "bit_reverse", "batch_inv",
           "NLIMB", "LIMB_BITS", "MASK"]

# limb geometry shared by the host codecs (limbs.py) and the tensor field
# (jfield.py): 16 little-endian limbs of 16 bits
NLIMB = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1

_FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """All constants needed for host and device arithmetic in one prime field."""

    name: str
    p: int
    # Montgomery constants for R = 2^256
    r_mont: int        # R mod p
    r2: int            # R^2 mod p
    n0_16: int         # -p^{-1} mod 2^16 (16-bit CIOS constant for the device kernel)
    # Domain constants (only meaningful for FR)
    generator: int     # multiplicative generator of F*
    two_adicity: int   # s with 2^s || p-1
    root_of_unity: int # generator^((p-1)/2^s)
    delta: int         # generator^(2^s) — generates the odd-order subgroup
    zeta: int          # element of order 3 (coset generator for the extended domain)

    # ---- host arithmetic -------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def to_mont(self, a: int) -> int:
        return (a * self.r_mont) % self.p

    def from_mont(self, a: int) -> int:
        # a * R^{-1} mod p
        return (a * pow(self.r_mont, -1, self.p)) % self.p

    def nth_root_of_unity(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity (for NTT domains)."""
        if log_n > self.two_adicity:
            raise ValueError(f"no 2^{log_n} root of unity in {self.name}")
        return pow(self.root_of_unity, 1 << (self.two_adicity - log_n), self.p)

    # Fixed-width byte encodings (little-endian, 32 bytes), matching the
    # `PrimeField::to_repr` convention of halo2curves.
    def to_bytes(self, a: int) -> bytes:
        return int(a % self.p).to_bytes(32, "little")

    def from_bytes(self, b: bytes) -> int:
        v = int.from_bytes(b, "little")
        if v >= self.p:
            raise ValueError("non-canonical field repr")
        return v


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def batch_inv(values, p: int):
    """Montgomery batch inversion of a list of nonzero ints mod p."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * values[i] % p
    return out


def _make_fr() -> FieldParams:
    p = _FR_MODULUS
    s = 28
    g = 7
    return FieldParams(
        name="Fr",
        p=p,
        r_mont=(1 << 256) % p,
        r2=pow(1 << 256, 2, p),
        n0_16=(-pow(p, -1, 1 << 16)) % (1 << 16),
        generator=g,
        two_adicity=s,
        root_of_unity=pow(g, (p - 1) >> s, p),
        delta=pow(g, 1 << s, p),
        zeta=pow(g, (p - 1) // 3, p),
    )


def _make_fq() -> FieldParams:
    p = _FQ_MODULUS
    return FieldParams(
        name="Fq",
        p=p,
        r_mont=(1 << 256) % p,
        r2=pow(1 << 256, 2, p),
        n0_16=(-pow(p, -1, 1 << 16)) % (1 << 16),
        generator=3,
        two_adicity=1,
        root_of_unity=p - 1,
        delta=pow(3, 2, p),
        zeta=pow(3, (p - 1) // 3, p),
    )


FR = _make_fr()
FQ = _make_fq()
