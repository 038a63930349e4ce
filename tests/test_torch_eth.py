"""The port's EVM layer (assembler, executor, precompiles, RLP, secp256k1,
JSON-RPC client and local node) on the vectors of tests/test_eth.py, each
also run through zerog_tpu.eth: the same bytecode and calldata give the same
output, success and gas in both executors; encodings and signatures are
equal byte for byte. Host Python ints only, tolerance zero. The verifier
contract itself (codegen and dry run on a real proof) is held against
zerog_tpu's in tests/test_torch_plonk.py, beside the k = 6 proof.
"""

import numpy as np
import pytest
import torch

from zerog_tpu.eth.evm import Evm as JEvm
from zerog_tpu.eth.evm_asm import Asm as JAsm, deployment_code as j_deployment_code
from zerog_tpu.eth.rlp import rlp_encode as j_rlp_encode
from zerog_tpu.eth.secp256k1 import sign as j_sign

from zerog_tpu_torch.curve.bn254 import G1_GEN, G2_GEN, g1_add, g1_mul, g1_neg
from zerog_tpu_torch.eth.evm import Evm
from zerog_tpu_torch.eth.evm_asm import Asm, deployment_code
from zerog_tpu_torch.eth.rlp import rlp_decode, rlp_encode
from zerog_tpu_torch.eth.secp256k1 import address_of_key, ecrecover, sign
from zerog_tpu_torch.transcript.keccak import keccak256

torch.set_num_threads(1)

CALLER = (0xFE).to_bytes(20, "big")


def _run_both(build, calldata=b""):
    """Assemble `build(asm)` in each package, deploy and call it in each
    executor; the two results must agree. Returns the port's."""
    results = []
    for asm_cls, dep_code, evm_cls in ((Asm, deployment_code, Evm),
                                       (JAsm, j_deployment_code, JEvm)):
        a = asm_cls()
        build(a)
        runtime = a.assemble()
        evm = evm_cls()
        dep = evm.deploy(CALLER, dep_code(runtime))
        assert dep.success and evm.code[dep.address] == runtime
        results.append((runtime, dep.gas_used, evm.call(CALLER, dep.address, calldata)))
    (rt, dgas, r), (jrt, jdgas, jr) = results
    assert rt == jrt and dgas == jdgas
    assert (r.success, r.output, r.gas_used) == (jr.success, jr.output, jr.gas_used)
    return r


def _word(r, i=0):
    return int.from_bytes(r.output[32 * i:32 * i + 32], "big")


# ---- programs: (build, calldata, check of the port's result) ---------------------

def _arith(a):
    a.push(7).push(5).op("MUL")          # 35
    a.push(3).op("ADD")                  # 38
    a.push(0).op("MSTORE")
    a.push(32).push(0).op("RETURN")


def _mulmod_addmod(a):
    a.push(97).push(50).push(60).op("MULMOD")
    a.push(0).op("MSTORE")
    a.push(97).push(90).push(20).op("ADDMOD")
    a.push(32).op("MSTORE")
    a.push(64).push(0).op("RETURN")


def _keccak(a):
    a.push(int.from_bytes(b"Z" * 32, "big")).push(0).op("MSTORE")
    a.push(32).push(0).op("KECCAK256")
    a.push(0).op("MSTORE")
    a.push(32).push(0).op("RETURN")


def _calldata(a):
    a.push(4).op("CALLDATALOAD")
    a.push(0).op("MSTORE")
    a.op("CALLDATASIZE").push(32).op("MSTORE")
    a.push(64).push(0).op("RETURN")


def _jumps(a):
    a.push(0).op("CALLDATALOAD").jumpi("ok")
    a.push(0).push(0).op("REVERT")
    a.label("ok")
    a.push(1).push(0).op("MSTORE")
    a.push(32).push(0).op("RETURN")


def _ec(a):
    # 7 G by ecmul into 0x80, then (7 G) + G by ecadd
    a.push(1).push(0).op("MSTORE")
    a.push(2).push(32).op("MSTORE")
    a.push(7).push(64).op("MSTORE")
    a.push(0x40).push(0x80).push(0x60).push(0).push(7).op("GAS", "STATICCALL", "POP")
    a.push(1).push(0xC0).op("MSTORE")
    a.push(2).push(0xE0).op("MSTORE")
    a.push(0x40).push(0x80).push(0x80).push(0x80).push(6).op("GAS", "STATICCALL", "POP")
    a.push(0x40).push(0x80).op("RETURN")


def _pairing(a):
    # e(G1, G2) e(-G1, G2) == 1
    for base, g1 in ((0, G1_GEN), (192, g1_neg(G1_GEN))):
        (xr, xi), (yr, yi) = G2_GEN
        for i, v in enumerate((g1[0], g1[1], xi, xr, yi, yr)):
            a.push(v).push(base + 32 * i).op("MSTORE")
    a.push(0x20).push(0x180).push(0x180).push(0).push(8).op("GAS", "STATICCALL", "POP")
    a.push(0x20).push(0x180).op("RETURN")


def _modexp(a):
    for off, v in ((0, 32), (32, 32), (64, 32), (96, 5), (128, 3), (160, 97)):
        a.push(v).push(off).op("MSTORE")
    a.push(0x20).push(0x180).push(0xC0).push(0).push(5).op("GAS", "STATICCALL", "POP")
    a.push(0x20).push(0x180).op("RETURN")


CALLDATA = bytes(range(1, 41))
PROGRAMS = {
    "arithmetic_and_memory": (_arith, b"", lambda r: _word(r) == 38),
    "mulmod_addmod": (_mulmod_addmod, b"",
                      lambda r: (_word(r), _word(r, 1)) == (3000 % 97, 13)),
    "keccak": (_keccak, b"", lambda r: r.output == keccak256(b"Z" * 32)),
    "calldata_ops": (_calldata, CALLDATA,
                     lambda r: r.output[:32] == CALLDATA[4:36] and _word(r, 1) == 40),
    "jump_taken": (_jumps, (1).to_bytes(32, "big"), lambda r: r.success),
    "jump_not_taken_reverts": (_jumps, b"", lambda r: not r.success),
    "ecmul_ecadd": (_ec, b"", lambda r: (_word(r), _word(r, 1))
                    == g1_add(g1_mul(G1_GEN, 7), G1_GEN)),
    "pairing": (_pairing, b"", lambda r: _word(r) == 1),
    "modexp": (_modexp, b"", lambda r: _word(r) == pow(5, 3, 97)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program(name):
    build, calldata, check = PROGRAMS[name]
    r = _run_both(build, calldata)
    assert check(r)


def test_deploy_returns_runtime():
    a = Asm()
    a.push(0).push(0).op("RETURN")
    rt = a.assemble()
    evm = Evm()
    dep = evm.deploy(CALLER, deployment_code(rt))
    assert dep.success and evm.code[dep.address] == rt
    assert deployment_code(rt) == j_deployment_code(rt)


# ---- RLP and secp256k1 ---------------------------------------------------------------

@pytest.mark.parametrize("item", [
    b"", b"\x00", b"\x7f", b"\x80", b"a" * 55, b"b" * 56,
    [b"\x01", [b"", b"abc"], b"x" * 60]], ids=lambda x: repr(x)[:12])
def test_rlp_roundtrip(item):
    enc = rlp_encode(item)
    assert enc == j_rlp_encode(item)
    assert rlp_decode(enc) == item


@pytest.mark.parametrize("value,enc", [(0, b"\x80"), (127, b"\x7f"),
                                       (256, b"\x82\x01\x00")])
def test_rlp_ints(value, enc):
    assert rlp_encode(value) == j_rlp_encode(value) == enc


@pytest.mark.parametrize("raw", [b"\x81\x01", rlp_encode(b"hello") + b"\x00"],
                         ids=["single_byte_not_direct", "trailing_bytes"])
def test_rlp_rejects_noncanonical(raw):
    with pytest.raises(ValueError):
        rlp_decode(raw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_secp256k1_sign_recover(seed):
    rng = np.random.default_rng(seed)
    priv = int.from_bytes(rng.bytes(31), "big") | 1
    msg = keccak256(rng.bytes(40))
    v, r, s = sign(msg, priv)
    assert (v, r, s) == j_sign(msg, priv)
    assert ecrecover(msg, v, r, s) == address_of_key(priv)
    assert ecrecover(keccak256(b"other"), v, r, s) != address_of_key(priv)
    n = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
    assert s <= n // 2      # high s is normalised


# ---- the JSON-RPC client and the local node ------------------------------------------

def test_client_deploy_and_call_roundtrip():
    """Sign a transaction, send it over HTTP to the local node, execute."""
    from zerog_tpu_torch.eth.client import EthClient

    a = Asm()
    a.push(0).op("CALLDATALOAD").push(1).op("ADD")
    a.push(0).op("MSTORE")
    a.push(32).push(0).op("RETURN")
    client = EthClient("local")
    try:
        addr = client.deploy_contract(deployment_code(a.assemble()))
        assert addr.startswith("0x") and len(addr) == 42
        res = client._node.evm.call(CALLER, bytes.fromhex(addr[2:]),
                                    (41).to_bytes(32, "big"))
        assert int.from_bytes(res.output, "big") == 42
    finally:
        client.close()


def test_local_node_state_persistence(tmp_path):
    """A contract deployed by one node is callable from a fresh node on the
    same state file; a call to an account without code is refused."""
    from zerog_tpu_torch.eth.client import DEV_PRIVATE_KEY, LocalNode

    state = str(tmp_path / "devnode.json")
    sender = address_of_key(DEV_PRIVATE_KEY)

    def send(node, to, data):
        nonce = node.evm.nonces.get(sender, 0)
        fields = [nonce, 10**9, 1_000_000, to or b"", 0, data]
        sighash = keccak256(rlp_encode(fields + [node.chain_id, b"", b""]))
        parity, r, s = sign(sighash, DEV_PRIVATE_KEY)
        raw = rlp_encode(fields + [35 + 2 * node.chain_id + parity, r, s])
        return node.receipts[node._send_raw(raw)]

    runtime = bytes.fromhex("6001600055")            # SSTORE(0, 1)
    initcode = bytes.fromhex("600580600b6000396000f3") + runtime
    receipt = send(LocalNode(state_path=state), None, initcode)
    assert receipt["status"] == "0x1"
    addr = bytes.fromhex(receipt["contractAddress"][2:])

    node2 = LocalNode(state_path=state)
    assert node2.evm.code[addr] == runtime
    assert send(node2, addr, b"")["status"] == "0x1"
    assert node2.evm.storage[addr][0] == 1
    with pytest.raises(ValueError, match="no contract code"):
        send(node2, b"\xaa" * 20, b"")
