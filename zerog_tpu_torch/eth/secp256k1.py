"""secp256k1 ECDSA: sign (RFC 6979 deterministic nonce) and recover.

Backs transaction signing in the chain client and the `ecrecover`
precompile of the local executor — the role the k256 crate plays for the
reference (`reference src/eth.rs:43`). Host-side bigint arithmetic;
never on the proving hot path.
"""

from __future__ import annotations

import hashlib
import hmac

from ..transcript.keccak import keccak256

__all__ = ["sign", "ecrecover", "pubkey", "address_of_key"]

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    if a[0] == b[0]:
        if (a[1] + b[1]) % P == 0:
            return None
        lam = (3 * a[0] * a[0]) * pow(2 * a[1], P - 2, P) % P
    else:
        lam = (b[1] - a[1]) * pow(b[0] - a[0], P - 2, P) % P
    x = (lam * lam - a[0] - b[0]) % P
    return (x, (lam * (a[0] - x) - a[1]) % P)


def _mul(pt, k):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def pubkey(priv: int):
    return _mul((GX, GY), priv % N)


def address_of_key(priv: int) -> bytes:
    x, y = pubkey(priv)
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def _rfc6979_k(msg32: bytes, priv: int) -> int:
    """Deterministic nonce (RFC 6979, SHA-256)."""
    x = priv.to_bytes(32, "big")
    k = b"\x00" * 32
    v = b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + x + msg32, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + msg32, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign(msg32: bytes, priv: int):
    """Returns (v, r, s) with low-s normalization; v in {0, 1} (y parity)."""
    z = int.from_bytes(msg32, "big") % N
    while True:
        k = _rfc6979_k(msg32, priv)
        pt = _mul((GX, GY), k)
        r = pt[0] % N
        if r == 0:
            msg32 = keccak256(msg32)
            continue
        s = (z + r * priv) * pow(k, N - 2, N) % N
        if s == 0:
            msg32 = keccak256(msg32)
            continue
        v = pt[1] & 1
        if s > N // 2:
            s = N - s
            v ^= 1
        return v, r, s


def ecrecover(msg32: bytes, v: int, r: int, s: int) -> bytes | None:
    """EVM-precompile semantics: v is 27/28, returns 20-byte address."""
    if v in (27, 28):
        v -= 27
    if v not in (0, 1) or not (1 <= r < N) or not (1 <= s < N):
        return None
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if y & 1 != v:
        y = P - y
    z = int.from_bytes(msg32, "big") % N
    r_inv = pow(r, N - 2, N)
    # Q = r^-1 (s*R - z*G)
    q = _add(_mul((x, y), s), _mul((GX, GY), N - z))
    q = _mul(q, r_inv)
    if q is None:
        return None
    return keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]
