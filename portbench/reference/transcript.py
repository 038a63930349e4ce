"""The EVM Fiat-Shamir transcript, reading side: big-endian 32-byte
encodings, challenge = keccak256(buffer) mod r, the buffer reset to the
digest after each squeeze, and a 0x01 byte appended when squeezing twice with
no new data; proof points uncompressed x || y.

Frozen copy of the Keccak reader of ``zerog_tpu_torch/transcript/transcript.py``,
taken when the benchmark was defined.
"""

from __future__ import annotations

from .bn254 import g1_is_on_curve
from .field import FR, FQ
from .keccak import keccak256

__all__ = ["KeccakTranscriptReader"]


class _KeccakCore:
    def __init__(self):
        self.buf = b""

    def common_scalar(self, s: int):
        self.buf += (int(s) % FR.p).to_bytes(32, "big")

    def common_point(self, pt):
        x, y = pt if pt is not None else (0, 0)
        self.buf += int(x).to_bytes(32, "big")
        self.buf += int(y).to_bytes(32, "big")

    def squeeze_challenge(self) -> int:
        if len(self.buf) == 32:
            # consecutive squeeze with no new data: domain-separate
            self.buf += b"\x01"
        digest = keccak256(self.buf)
        self.buf = digest
        return int.from_bytes(digest, "big") % FR.p


class KeccakTranscriptReader(_KeccakCore):
    def __init__(self, proof: bytes):
        super().__init__()
        self.data = proof
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("proof too short")
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def read_scalar(self) -> int:
        v = int.from_bytes(self._take(32), "big")
        if v >= FR.p:
            raise ValueError("non-canonical scalar in proof")
        self.common_scalar(v)
        return v

    def read_point(self):
        x = int.from_bytes(self._take(32), "big")
        y = int.from_bytes(self._take(32), "big")
        if x >= FQ.p or y >= FQ.p:
            raise ValueError("non-canonical point coordinate")
        pt = (x, y) if not (x == 0 and y == 0) else None
        if not g1_is_on_curve(pt):
            raise ValueError("proof point not on curve")
        self.common_point(pt)
        return pt

    def finished(self) -> bool:
        return self.off == len(self.data)
