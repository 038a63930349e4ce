"""A small EVM assembler.

The verifier contract (`codegen.py`) is emitted as straight-line EVM assembly
— the counterpart of the reference's snark-verifier Yul pipeline
(`reference src/eth.rs:68-106` compiles the vk to Yul and then runs
`compile_yul`). We skip the Yul detour and assemble bytecode directly: the
verifier is a linear program over a memory register file, so a full compiler
buys nothing.

Supports labels (2-byte PUSH2 references, two-pass fixup), auto-sized pushes,
and a deployment wrapper (constructor that CODECOPYs the runtime and RETURNs
it — what `gen_evm_verifier` hands to `deploy`/`dry_run`).
"""

from __future__ import annotations

__all__ = ["Asm", "OPCODES", "deployment_code"]

# fmt: off
OPCODES = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "SMOD": 0x07, "ADDMOD": 0x08, "MULMOD": 0x09,
    "EXP": 0x0A, "SIGNEXTEND": 0x0B,
    "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13, "EQ": 0x14,
    "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18, "NOT": 0x19,
    "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C, "SAR": 0x1D,
    "KECCAK256": 0x20,
    "ADDRESS": 0x30, "BALANCE": 0x31, "ORIGIN": 0x32, "CALLER": 0x33,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "CALLDATACOPY": 0x37, "CODESIZE": 0x38, "CODECOPY": 0x39,
    "GASPRICE": 0x3A, "EXTCODESIZE": 0x3B, "EXTCODECOPY": 0x3C,
    "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E, "EXTCODEHASH": 0x3F,
    "BLOCKHASH": 0x40, "COINBASE": 0x41, "TIMESTAMP": 0x42, "NUMBER": 0x43,
    "PREVRANDAO": 0x44, "GASLIMIT": 0x45, "CHAINID": 0x46, "SELFBALANCE": 0x47,
    "BASEFEE": 0x48,
    "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52, "MSTORE8": 0x53,
    "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56, "JUMPI": 0x57, "PC": 0x58,
    "MSIZE": 0x59, "GAS": 0x5A, "JUMPDEST": 0x5B,
    "PUSH0": 0x5F,
    "CREATE": 0xF0, "CALL": 0xF1, "CALLCODE": 0xF2, "RETURN": 0xF3,
    "DELEGATECALL": 0xF4, "CREATE2": 0xF5, "STATICCALL": 0xFA,
    "REVERT": 0xFD, "INVALID": 0xFE, "SELFDESTRUCT": 0xFF,
}
# fmt: on
for _i in range(1, 33):
    OPCODES[f"PUSH{_i}"] = 0x5F + _i
for _i in range(1, 17):
    OPCODES[f"DUP{_i}"] = 0x80 + _i - 1
    OPCODES[f"SWAP{_i}"] = 0x90 + _i - 1


class _LabelRef:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class Asm:
    """Two-pass assembler: emit ops/pushes/labels, then `assemble()`."""

    def __init__(self):
        self._items: list = []  # bytes | _LabelRef

    def op(self, *names: str) -> "Asm":
        for name in names:
            self._items.append(bytes([OPCODES[name]]))
        return self

    def push(self, value: int) -> "Asm":
        value = int(value)
        if value < 0:
            value %= 1 << 256
        if value == 0:
            return self.op("PUSH0")
        data = value.to_bytes((value.bit_length() + 7) // 8, "big")
        self._items.append(bytes([OPCODES[f"PUSH{len(data)}"]]) + data)
        return self

    def label(self, name: str) -> "Asm":
        self._items.append(("label", name))
        return self

    def push_label(self, name: str) -> "Asm":
        self._items.append(_LabelRef(name))
        return self

    def jump(self, name: str) -> "Asm":
        return self.push_label(name).op("JUMP")

    def jumpi(self, name: str) -> "Asm":
        return self.push_label(name).op("JUMPI")

    def raw(self, data: bytes) -> "Asm":
        self._items.append(bytes(data))
        return self

    def assemble(self) -> bytes:
        # pass 1: compute offsets (labels are JUMPDEST = 1 byte; refs PUSH2+2)
        offsets: dict[str, int] = {}
        pc = 0
        for it in self._items:
            if isinstance(it, tuple):
                offsets[it[1]] = pc
                pc += 1
            elif isinstance(it, _LabelRef):
                pc += 3
            else:
                pc += len(it)
        out = bytearray()
        for it in self._items:
            if isinstance(it, tuple):
                out.append(OPCODES["JUMPDEST"])
            elif isinstance(it, _LabelRef):
                off = offsets[it.name]
                out += bytes([OPCODES["PUSH2"]]) + off.to_bytes(2, "big")
            else:
                out += it
        return bytes(out)


def deployment_code(runtime: bytes) -> bytes:
    """Wrap runtime bytecode in a constructor that returns it (the standard
    CODECOPY/RETURN prologue — the deployable artifact)."""
    # PUSH2 len, PUSH2 off, PUSH0, CODECOPY, PUSH2 len, PUSH0, RETURN = 13 B
    n = len(runtime)
    prologue = (
        bytes([OPCODES["PUSH2"]]) + n.to_bytes(2, "big")
        + bytes([OPCODES["PUSH2"]]) + (13).to_bytes(2, "big")
        + bytes([OPCODES["PUSH0"], OPCODES["CODECOPY"]])
        + bytes([OPCODES["PUSH2"]]) + n.to_bytes(2, "big")
        + bytes([OPCODES["PUSH0"], OPCODES["RETURN"]])
    )
    assert len(prologue) == 13
    return prologue + runtime
