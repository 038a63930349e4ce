"""A minimal EVM executor for local dry-runs.

Counterpart of the reference's revm-based
`snark_verifier::loader::evm::ExecutorBuilder` flow
(`reference src/eth.rs:109-138`): deploy bytecode, call it with raw
calldata, report gas. Implements the instruction subset a verifier contract
can reach plus the BN254/modexp precompiles (backed by this repo's host
`curve.bn254` arithmetic — which makes the dry-run an *independent* check of
the prover's transcript encoding).

Gas follows the Shanghai schedule (EIP-150/2200/2565/1108 revisions) closely
enough for meaningful gas reports; it is not a consensus implementation.
"""

from __future__ import annotations

import dataclasses

from ..transcript.keccak import keccak256

__all__ = ["Evm", "ExecResult", "Revert"]

U256 = (1 << 256) - 1
_SIGN = 1 << 255


def _sgn(v: int) -> int:
    return v - (1 << 256) if v & _SIGN else v


# ---- gas schedule (Shanghai) ------------------------------------------------

G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10
G_BASE = 2
G_JUMPDEST = 1
G_EXP = 10
G_EXPBYTE = 50
G_KECCAK = 30
G_KECCAKWORD = 6
G_COPY = 3
G_MEMORY = 3
G_CALL = 100       # warm account access (EIP-2929)
G_COLD_ACCOUNT = 2600
G_TX = 21000
G_TXDATA_ZERO = 4
G_TXDATA_NONZERO = 16
G_CREATE = 32000
G_CODEDEPOSIT = 200
G_INITCODE_WORD = 2  # EIP-3860


def _mem_gas(words: int) -> int:
    return G_MEMORY * words + words * words // 512


class Revert(Exception):
    def __init__(self, data: bytes = b""):
        super().__init__(f"execution reverted ({len(data)} bytes)")
        self.data = data


class _OutOfGas(Exception):
    pass


@dataclasses.dataclass
class ExecResult:
    success: bool
    output: bytes
    gas_used: int
    address: bytes | None = None  # for deployments


# ---- precompiles ------------------------------------------------------------

_BN_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
_BN_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _pre_ecrecover(data: bytes):
    from .secp256k1 import ecrecover

    data = data.ljust(128, b"\x00")[:128]
    h = data[0:32]
    v = int.from_bytes(data[32:64], "big")
    r = int.from_bytes(data[64:96], "big")
    s = int.from_bytes(data[96:128], "big")
    try:
        addr = ecrecover(h, v, r, s)
    except Exception:
        return b"", 3000
    return (b"\x00" * 12 + addr) if addr else b"", 3000


def _pre_identity(data: bytes):
    return data, 15 + 3 * ((len(data) + 31) // 32)


def _pre_modexp(data: bytes):
    # EIP-2565
    def word(i):
        return int.from_bytes(data[i : i + 32].ljust(32, b"\x00"), "big")

    lb, le, lm = word(0), word(32), word(64)
    if lb > 1024 or le > 1024 or lm > 1024:
        raise Revert(b"modexp operand too large")
    rest = data[96:].ljust(lb + le + lm, b"\x00")
    b = int.from_bytes(rest[:lb], "big")
    e = int.from_bytes(rest[lb : lb + le], "big")
    m = int.from_bytes(rest[lb + le : lb + le + lm], "big")
    mult = ((max(lb, lm) + 7) // 8) ** 2
    it = max(1, (8 * (le - 32) if le > 32 else 0) + (e.bit_length() - 1 if e > 0 else 0))
    gas = max(200, mult * it // 3)
    out = pow(b, e, m) if m else 0
    return out.to_bytes(lm, "big") if lm else b"", gas


def _read_g1(data: bytes, off: int):
    x = int.from_bytes(data[off : off + 32], "big")
    y = int.from_bytes(data[off + 32 : off + 64], "big")
    if x >= _BN_P or y >= _BN_P:
        raise Revert(b"bn254 coordinate out of range")
    if x == 0 and y == 0:
        return None
    if (y * y - x * x * x - 3) % _BN_P != 0:
        raise Revert(b"bn254 point not on curve")
    return (x, y)


def _write_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _pre_ecadd(data: bytes):
    from ..curve.bn254 import g1_add

    data = data.ljust(128, b"\x00")
    return _write_g1(g1_add(_read_g1(data, 0), _read_g1(data, 64))), 150


def _pre_ecmul(data: bytes):
    from ..curve.bn254 import g1_mul

    data = data.ljust(96, b"\x00")
    s = int.from_bytes(data[64:96], "big")  # NOT reduced-checked per spec
    return _write_g1(g1_mul(_read_g1(data, 0), s % _BN_R)), 6000


def _pre_ecpairing(data: bytes):
    from ..curve.bn254 import pairing_product_is_one, g2_is_on_curve

    if len(data) % 192 != 0:
        raise Revert(b"pairing input not a multiple of 192")
    k = len(data) // 192
    pairs = []
    for i in range(k):
        off = i * 192
        g1 = _read_g1(data, off)
        # G2 coords: (x_im, x_re, y_im, y_re) big-endian per EIP-197
        xi = int.from_bytes(data[off + 64 : off + 96], "big")
        xr = int.from_bytes(data[off + 96 : off + 128], "big")
        yi = int.from_bytes(data[off + 128 : off + 160], "big")
        yr = int.from_bytes(data[off + 160 : off + 192], "big")
        if max(xi, xr, yi, yr) >= _BN_P:
            raise Revert(b"bn254 g2 coordinate out of range")
        g2 = None if (xi | xr | yi | yr) == 0 else ((xr, xi), (yr, yi))
        if g2 is not None and not g2_is_on_curve(g2):
            raise Revert(b"bn254 g2 point not on curve")
        if g1 is not None and g2 is not None:
            pairs.append((g1, g2))
    ok = pairing_product_is_one(pairs) if pairs else True
    return (1 if ok else 0).to_bytes(32, "big"), 45000 + 34000 * k


PRECOMPILES = {
    1: _pre_ecrecover,
    4: _pre_identity,
    5: _pre_modexp,
    6: _pre_ecadd,
    7: _pre_ecmul,
    8: _pre_ecpairing,
}


# ---- the interpreter ---------------------------------------------------------


class _Frame:
    __slots__ = ("code", "data", "stack", "mem", "pc", "gas", "valid_dests",
                 "returndata")

    def __init__(self, code: bytes, data: bytes, gas: int):
        self.code = code
        self.data = data
        self.stack: list[int] = []
        self.mem = bytearray()
        self.pc = 0
        self.gas = gas
        self.returndata = b""
        # JUMPDEST analysis (skip push immediates)
        dests = set()
        i = 0
        while i < len(code):
            op = code[i]
            if op == 0x5B:
                dests.add(i)
            if 0x60 <= op <= 0x7F:
                i += op - 0x5F
            i += 1
        self.valid_dests = dests

    def charge(self, amount: int):
        if self.gas < amount:
            raise _OutOfGas()
        self.gas -= amount

    def mem_expand(self, offset: int, size: int):
        if size == 0:
            return
        end = offset + size
        new_words = (end + 31) // 32
        old_words = (len(self.mem) + 31) // 32
        if new_words > old_words:
            self.charge(_mem_gas(new_words) - _mem_gas(old_words))
            self.mem.extend(b"\x00" * (new_words * 32 - len(self.mem)))

    def mget(self, off: int, size: int) -> bytes:
        self.mem_expand(off, size)
        return bytes(self.mem[off : off + size])

    def mset(self, off: int, data: bytes):
        self.mem_expand(off, len(data))
        self.mem[off : off + len(data)] = data


class Evm:
    """A single-shot executor: `deploy` then `call`. Stateless between
    transactions apart from deployed code and storage."""

    def __init__(self, gas_limit: int = 2**63):
        self.gas_limit = gas_limit
        self.code: dict[bytes, bytes] = {}
        self.storage: dict[bytes, dict[int, int]] = {}
        self.nonces: dict[bytes, int] = {}

    # -- public API ------------------------------------------------------

    def deploy(self, caller: bytes, initcode: bytes, gas: int | None = None
               ) -> ExecResult:
        gas = gas or self.gas_limit
        nonce = self.nonces.get(caller, 0)
        self.nonces[caller] = nonce + 1
        from .rlp import rlp_encode

        addr = keccak256(rlp_encode([caller, nonce]))[12:]
        intrinsic = G_TX + G_CREATE + self._calldata_gas(initcode) \
            + G_INITCODE_WORD * ((len(initcode) + 31) // 32)
        try:
            output, gas_left = self._run(initcode, b"", gas - intrinsic, addr)
        except Revert as e:
            return ExecResult(False, e.data, gas)
        except _OutOfGas:
            return ExecResult(False, b"", gas)
        deposit = G_CODEDEPOSIT * len(output)
        if gas_left < deposit:
            return ExecResult(False, b"", gas)
        gas_left -= deposit
        self.code[addr] = output
        self.storage.setdefault(addr, {})
        return ExecResult(True, output, gas - gas_left, address=addr)

    def call(self, caller: bytes, to: bytes, data: bytes, gas: int | None = None
             ) -> ExecResult:
        gas = gas or self.gas_limit
        code = self.code.get(to, b"")
        intrinsic = G_TX + self._calldata_gas(data)
        try:
            output, gas_left = self._run(code, data, gas - intrinsic, to)
        except Revert as e:
            return ExecResult(False, e.data, gas)
        except _OutOfGas:
            return ExecResult(False, b"", gas)
        return ExecResult(True, output, gas - gas_left)

    @staticmethod
    def _calldata_gas(data: bytes) -> int:
        zeros = data.count(0)
        return G_TXDATA_ZERO * zeros + G_TXDATA_NONZERO * (len(data) - zeros)

    # -- core loop --------------------------------------------------------

    def _run(self, code: bytes, data: bytes, gas: int, self_addr: bytes):
        if gas < 0:
            raise _OutOfGas()
        f = _Frame(code, data, gas)
        stack = f.stack
        store = self.storage.setdefault(self_addr, {})

        def pop():
            return stack.pop()

        while f.pc < len(code):
            op = code[f.pc]
            f.pc += 1
            if 0x60 <= op <= 0x7F:  # PUSH1..32
                n = op - 0x5F
                f.charge(G_VERYLOW)
                stack.append(int.from_bytes(code[f.pc : f.pc + n], "big"))
                f.pc += n
            elif op == 0x5F:  # PUSH0
                f.charge(G_BASE)
                stack.append(0)
            elif 0x80 <= op <= 0x8F:  # DUP
                f.charge(G_VERYLOW)
                stack.append(stack[-(op - 0x7F)])
            elif 0x90 <= op <= 0x9F:  # SWAP
                f.charge(G_VERYLOW)
                n = op - 0x8F
                stack[-1], stack[-n - 1] = stack[-n - 1], stack[-1]
            elif op == 0x01:  # ADD
                f.charge(G_VERYLOW)
                stack.append((pop() + pop()) & U256)
            elif op == 0x02:  # MUL
                f.charge(G_LOW)
                stack.append((pop() * pop()) & U256)
            elif op == 0x03:  # SUB
                f.charge(G_VERYLOW)
                a, b = pop(), pop()
                stack.append((a - b) & U256)
            elif op == 0x04:  # DIV
                f.charge(G_LOW)
                a, b = pop(), pop()
                stack.append(a // b if b else 0)
            elif op == 0x06:  # MOD
                f.charge(G_LOW)
                a, b = pop(), pop()
                stack.append(a % b if b else 0)
            elif op == 0x08:  # ADDMOD
                f.charge(G_MID)
                a, b, m = pop(), pop(), pop()
                stack.append((a + b) % m if m else 0)
            elif op == 0x09:  # MULMOD
                f.charge(G_MID)
                a, b, m = pop(), pop(), pop()
                stack.append((a * b) % m if m else 0)
            elif op == 0x0A:  # EXP
                a, e = pop(), pop()
                f.charge(G_EXP + G_EXPBYTE * ((e.bit_length() + 7) // 8))
                stack.append(pow(a, e, 1 << 256))
            elif op == 0x10:  # LT
                f.charge(G_VERYLOW)
                a, b = pop(), pop()
                stack.append(1 if a < b else 0)
            elif op == 0x11:  # GT
                f.charge(G_VERYLOW)
                a, b = pop(), pop()
                stack.append(1 if a > b else 0)
            elif op == 0x12:  # SLT
                f.charge(G_VERYLOW)
                a, b = pop(), pop()
                stack.append(1 if _sgn(a) < _sgn(b) else 0)
            elif op == 0x13:  # SGT
                f.charge(G_VERYLOW)
                a, b = pop(), pop()
                stack.append(1 if _sgn(a) > _sgn(b) else 0)
            elif op == 0x14:  # EQ
                f.charge(G_VERYLOW)
                stack.append(1 if pop() == pop() else 0)
            elif op == 0x15:  # ISZERO
                f.charge(G_VERYLOW)
                stack.append(1 if pop() == 0 else 0)
            elif op == 0x16:  # AND
                f.charge(G_VERYLOW)
                stack.append(pop() & pop())
            elif op == 0x17:  # OR
                f.charge(G_VERYLOW)
                stack.append(pop() | pop())
            elif op == 0x18:  # XOR
                f.charge(G_VERYLOW)
                stack.append(pop() ^ pop())
            elif op == 0x19:  # NOT
                f.charge(G_VERYLOW)
                stack.append(pop() ^ U256)
            elif op == 0x1A:  # BYTE
                f.charge(G_VERYLOW)
                i, x = pop(), pop()
                stack.append((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                f.charge(G_VERYLOW)
                s, v = pop(), pop()
                stack.append((v << s) & U256 if s < 256 else 0)
            elif op == 0x1C:  # SHR
                f.charge(G_VERYLOW)
                s, v = pop(), pop()
                stack.append(v >> s if s < 256 else 0)
            elif op == 0x20:  # KECCAK256
                off, size = pop(), pop()
                f.charge(G_KECCAK + G_KECCAKWORD * ((size + 31) // 32))
                stack.append(int.from_bytes(keccak256(f.mget(off, size)), "big"))
            elif op == 0x33:  # CALLER
                f.charge(G_BASE)
                stack.append(0xFE)  # fixed caller for dry runs
            elif op == 0x34:  # CALLVALUE
                f.charge(G_BASE)
                stack.append(0)
            elif op == 0x35:  # CALLDATALOAD
                f.charge(G_VERYLOW)
                off = pop()
                stack.append(int.from_bytes(
                    data[off : off + 32].ljust(32, b"\x00"), "big"))
            elif op == 0x36:  # CALLDATASIZE
                f.charge(G_BASE)
                stack.append(len(data))
            elif op == 0x37:  # CALLDATACOPY
                dst, src, size = pop(), pop(), pop()
                f.charge(G_VERYLOW + G_COPY * ((size + 31) // 32))
                f.mset(dst, data[src : src + size].ljust(size, b"\x00"))
            elif op == 0x38:  # CODESIZE
                f.charge(G_BASE)
                stack.append(len(code))
            elif op == 0x39:  # CODECOPY
                dst, src, size = pop(), pop(), pop()
                f.charge(G_VERYLOW + G_COPY * ((size + 31) // 32))
                f.mset(dst, code[src : src + size].ljust(size, b"\x00"))
            elif op == 0x3D:  # RETURNDATASIZE
                f.charge(G_BASE)
                stack.append(len(f.returndata))
            elif op == 0x3E:  # RETURNDATACOPY
                dst, src, size = pop(), pop(), pop()
                f.charge(G_VERYLOW + G_COPY * ((size + 31) // 32))
                if src + size > len(f.returndata):
                    raise Revert(b"returndatacopy out of bounds")
                f.mset(dst, f.returndata[src : src + size])
            elif op == 0x50:  # POP
                f.charge(G_BASE)
                pop()
            elif op == 0x51:  # MLOAD
                f.charge(G_VERYLOW)
                stack.append(int.from_bytes(f.mget(pop(), 32), "big"))
            elif op == 0x52:  # MSTORE
                f.charge(G_VERYLOW)
                off, val = pop(), pop()
                f.mset(off, val.to_bytes(32, "big"))
            elif op == 0x53:  # MSTORE8
                f.charge(G_VERYLOW)
                off, val = pop(), pop()
                f.mset(off, bytes([val & 0xFF]))
            elif op == 0x54:  # SLOAD (always "warm" here)
                f.charge(100)
                stack.append(store.get(pop(), 0))
            elif op == 0x55:  # SSTORE (flat approximation)
                key, val = pop(), pop()
                f.charge(20000 if store.get(key, 0) == 0 and val else 5000)
                store[key] = val
            elif op == 0x56:  # JUMP
                f.charge(G_MID)
                dest = pop()
                if dest not in f.valid_dests:
                    raise Revert(b"invalid jump")
                f.pc = dest
            elif op == 0x57:  # JUMPI
                f.charge(G_HIGH)
                dest, cond = pop(), pop()
                if cond:
                    if dest not in f.valid_dests:
                        raise Revert(b"invalid jump")
                    f.pc = dest
            elif op == 0x58:  # PC
                f.charge(G_BASE)
                stack.append(f.pc - 1)
            elif op == 0x59:  # MSIZE
                f.charge(G_BASE)
                stack.append((len(f.mem) + 31) // 32 * 32)
            elif op == 0x5A:  # GAS
                f.charge(G_BASE)
                stack.append(f.gas)
            elif op == 0x5B:  # JUMPDEST
                f.charge(G_JUMPDEST)
            elif op in (0xF1, 0xFA):  # CALL / STATICCALL
                if op == 0xF1:
                    gas_req, to, _value, ain, asz, rout, rsz = (
                        pop(), pop(), pop(), pop(), pop(), pop(), pop())
                else:
                    gas_req, to, ain, asz, rout, rsz = (
                        pop(), pop(), pop(), pop(), pop(), pop())
                payload = f.mget(ain, asz)
                f.mem_expand(rout, rsz)
                pre = PRECOMPILES.get(to)
                if pre is not None:
                    f.charge(G_CALL)
                    try:
                        out, pgas = pre(payload)
                        f.charge(pgas)
                        f.returndata = out
                        f.mset(rout, out[:rsz].ljust(min(rsz, len(out)), b"\x00"))
                        stack.append(1)
                    except Revert:
                        f.returndata = b""
                        stack.append(0)
                else:
                    # nested contract calls: execute with a gas slice
                    f.charge(G_COLD_ACCOUNT)
                    sub_code = self.code.get(to.to_bytes(20, "big"), b"")
                    avail = f.gas - f.gas // 64
                    sub_gas = min(gas_req, avail)
                    f.charge(sub_gas)
                    try:
                        out, left = self._run(sub_code, payload, sub_gas,
                                              to.to_bytes(20, "big"))
                        f.gas += left
                        f.returndata = out
                        f.mset(rout, out[:rsz])
                        stack.append(1)
                    except Revert:
                        f.returndata = b""
                        stack.append(0)
                    except _OutOfGas:
                        f.returndata = b""
                        stack.append(0)
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return f.mget(off, size), f.gas
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                raise Revert(f.mget(off, size))
            elif op == 0x00:  # STOP
                return b"", f.gas
            elif op == 0xFE:  # INVALID
                raise _OutOfGas()
            else:
                raise Revert(f"unsupported opcode 0x{op:02x}".encode())
        return b"", f.gas
