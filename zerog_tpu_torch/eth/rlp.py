"""RLP encoding/decoding (Ethereum's recursive length prefix).

Needed for transaction serialization and contract-address derivation in the
chain client — the role ethers-rs plays for the reference
(`reference src/eth.rs:140-227`).
"""

from __future__ import annotations

__all__ = ["rlp_encode", "rlp_decode"]


def _to_bytes(item) -> bytes:
    if isinstance(item, bytes):
        return item
    if isinstance(item, bytearray):
        return bytes(item)
    if isinstance(item, str):
        return item.encode()
    if isinstance(item, int):
        if item < 0:
            raise ValueError("RLP cannot encode negative integers")
        if item == 0:
            return b""
        return item.to_bytes((item.bit_length() + 7) // 8, "big")
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(lb)]) + lb


def rlp_encode(item) -> bytes:
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    data = _to_bytes(item)
    if len(data) == 1 and data[0] < 0x80:
        return data
    return _encode_length(len(data), 0x80) + data


def rlp_decode(data: bytes):
    """Decode a single RLP item; raises on trailing bytes."""
    item, rest = _decode_one(memoryview(data))
    if len(rest) != 0:
        raise ValueError("trailing bytes after RLP item")
    return item


def _decode_one(mv):
    if len(mv) == 0:
        raise ValueError("empty RLP input")
    b0 = mv[0]
    if b0 < 0x80:
        return bytes(mv[0:1]), mv[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        if len(mv) < 1 + n:
            raise ValueError("short RLP string")
        if n == 1 and mv[1] < 0x80:
            raise ValueError("non-canonical RLP single byte")
        return bytes(mv[1 : 1 + n]), mv[1 + n :]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(bytes(mv[1 : 1 + ln]), "big")
        if n < 56:
            raise ValueError("non-canonical RLP length")
        return bytes(mv[1 + ln : 1 + ln + n]), mv[1 + ln + n :]
    if b0 < 0xF8:
        n = b0 - 0xC0
        payload, rest = mv[1 : 1 + n], mv[1 + n :]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(bytes(mv[1 : 1 + ln]), "big")
        if n < 56:
            raise ValueError("non-canonical RLP length")
        payload, rest = mv[1 + ln : 1 + ln + n], mv[1 + ln + n :]
    items = []
    while len(payload):
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
