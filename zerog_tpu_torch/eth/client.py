"""Chain client: deploy verifier contracts and submit proofs over JSON-RPC.

Counterpart of the reference's ethers-rs `EthClient`
(`reference src/eth.rs:149-227`): endpoint "local" spawns an in-process
dev node (the Anvil role) backed by the local executor (`evm.py`); any other
endpoint is treated as an HTTP JSON-RPC URL and requires `ETH_PRIVATE_KEY`.
Transactions are legacy type-0 with EIP-155 signatures, signed with the
in-repo secp256k1.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import urllib.request

from ..transcript.keccak import keccak256
from .evm import Evm
from .rlp import rlp_encode, rlp_decode
from .secp256k1 import sign, ecrecover, address_of_key

__all__ = ["EthClient", "LocalNode", "DEV_PRIVATE_KEY"]

# anvil-style well-known dev key (account 0)
DEV_PRIVATE_KEY = 0xAC0974BEC39A17E36BA4A6B4D238FF944BACB478CBED5EFCAE784D7BF4F2FF80
LOCAL_CHAIN_ID = 31337


class LocalNode:
    """A dev JSON-RPC node backed by the local EVM executor.

    Unlike a long-running Anvil, the in-process node dies with the CLI
    invocation that spawned it, so `state_path` (or the
    ZEROG_DEV_NODE_STATE env var) persists world state (code, storage,
    nonces, block height) to disk: a contract deployed by one CLI process is
    callable from the next — matching the reference's test_cli.sh flow where
    deploy-evm-verifier and submit-proof hit the same live Anvil
    (reference test_cli.sh:40-83)."""

    def __init__(self, chain_id: int = LOCAL_CHAIN_ID,
                 state_path: str | None = None):
        self.chain_id = chain_id
        self.evm = Evm()
        self.receipts: dict[str, dict] = {}
        self.block = 0
        self._server = None
        self.state_path = state_path or os.environ.get("ZEROG_DEV_NODE_STATE")
        if self.state_path and os.path.exists(self.state_path):
            self._load_state()

    # -- state persistence ---------------------------------------------------

    def _load_state(self):
        with open(self.state_path) as f:
            st = json.load(f)
        self.block = st["block"]
        self.evm.code = {bytes.fromhex(a): bytes.fromhex(c)
                         for a, c in st["code"].items()}
        self.evm.storage = {
            bytes.fromhex(a): {int(k): int(v) for k, v in slots.items()}
            for a, slots in st["storage"].items()
        }
        self.evm.nonces = {bytes.fromhex(a): n for a, n in st["nonces"].items()}

    def _save_state(self):
        if not self.state_path:
            return
        st = {
            "block": self.block,
            "code": {a.hex(): c.hex() for a, c in self.evm.code.items()},
            "storage": {a.hex(): {str(k): str(v) for k, v in slots.items()}
                        for a, slots in self.evm.storage.items()},
            "nonces": {a.hex(): n for a, n in self.evm.nonces.items()},
        }
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, self.state_path)

    # -- JSON-RPC dispatch --------------------------------------------------

    def rpc(self, method: str, params: list):
        if method == "eth_chainId":
            return hex(self.chain_id)
        if method == "eth_blockNumber":
            return hex(self.block)
        if method == "eth_gasPrice":
            return hex(10**9)
        if method == "eth_getTransactionCount":
            addr = bytes.fromhex(params[0][2:])
            return hex(self.evm.nonces.get(addr, 0))
        if method == "eth_sendRawTransaction":
            return self._send_raw(bytes.fromhex(params[0][2:]))
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(params[0])
        if method == "eth_estimateGas":
            return hex(30_000_000)
        raise ValueError(f"unsupported method {method}")

    def _send_raw(self, raw: bytes) -> str:
        items = rlp_decode(raw)
        if not isinstance(items, list) or len(items) != 9:
            raise ValueError("expected a legacy transaction")
        nonce, gas_price, gas, to, value, data, v, r, s = items
        v_i = int.from_bytes(v, "big")
        chain_id = (v_i - 35) // 2 if v_i >= 35 else None
        if chain_id is not None:
            parity = v_i - 35 - 2 * chain_id
            sighash = keccak256(rlp_encode(
                [nonce, gas_price, gas, to, value, data, chain_id, b"", b""]))
        else:
            parity = v_i - 27
            sighash = keccak256(rlp_encode(
                [nonce, gas_price, gas, to, value, data]))
        sender = ecrecover(sighash, parity,
                           int.from_bytes(r, "big"), int.from_bytes(s, "big"))
        if sender is None:
            raise ValueError("invalid transaction signature")
        gas_limit = int.from_bytes(gas, "big") or None
        if len(to) == 0:
            res = self.evm.deploy(sender, data, gas_limit)
        else:
            # a call into an account with no code would trivially "succeed"
            # (nothing executes); a dev node used for verifier testing must
            # treat that as an error, not a passing verification
            if self.evm.code.get(bytes(to), b"") == b"":
                raise ValueError(f"no contract code at 0x{bytes(to).hex()}")
            res = self.evm.call(sender, to, data, gas_limit)
        self.block += 1
        self._save_state()
        txh = "0x" + keccak256(raw).hex()
        self.receipts[txh] = {
            "transactionHash": txh,
            "blockNumber": hex(self.block),
            "gasUsed": hex(res.gas_used),
            "status": "0x1" if res.success else "0x0",
            "contractAddress": ("0x" + res.address.hex())
            if res.address is not None else None,
        }
        return txh

    # -- HTTP server (the wire protocol, so the client path is identical
    #    against a local node and a real endpoint) ---------------------------

    def serve(self) -> str:
        node = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                req = json.loads(body)
                try:
                    result = node.rpc(req["method"], req.get("params", []))
                    resp = {"jsonrpc": "2.0", "id": req["id"], "result": result}
                except Exception as e:  # noqa: BLE001
                    resp = {"jsonrpc": "2.0", "id": req.get("id"),
                            "error": {"code": -32000, "message": str(e)}}
                out = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def _print_receipt(receipt: dict):
    print("== Transaction summary")
    print(f"  Transaction hash: {receipt['transactionHash']}")
    print(f"  Included in block: {int(receipt['blockNumber'], 16)}")
    print(f"  Gas used: {int(receipt['gasUsed'], 16)}")


class EthClient:
    """Deploy contracts and submit proofs. endpoint="local" runs an
    in-process dev node; otherwise ETH_PRIVATE_KEY must be set."""

    def __init__(self, endpoint: str = "local"):
        self._node = None
        if endpoint in ("local", "anvil"):
            self._node = LocalNode()
            self.endpoint = self._node.serve()
            self.private_key = DEV_PRIVATE_KEY
            # the in-process node is on the loopback: never through a proxy
            self._open = urllib.request.build_opener(
                urllib.request.ProxyHandler({})).open
        else:
            self.endpoint = endpoint
            self._open = urllib.request.urlopen
            key = os.environ.get("ETH_PRIVATE_KEY")
            if not key:
                raise ValueError("ETH_PRIVATE_KEY is not set")
            self.private_key = int(key, 16)
        self.address = address_of_key(self.private_key)
        self.chain_id = int(self._rpc("eth_chainId"), 16)

    def close(self):
        if self._node is not None:
            self._node.close()

    def _rpc(self, method: str, *params):
        req = json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                          "params": list(params)}).encode()
        r = urllib.request.Request(self.endpoint, data=req,
                                   headers={"Content-Type": "application/json"})
        with self._open(r, timeout=120) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise ValueError(f"rpc error: {out['error']}")
        return out["result"]

    def _send_tx(self, to: bytes | None, data: bytes) -> dict:
        nonce = int(self._rpc("eth_getTransactionCount",
                              "0x" + self.address.hex(), "pending"), 16)
        gas_price = int(self._rpc("eth_gasPrice"), 16)
        gas = 30_000_000
        fields = [nonce, gas_price, gas, to or b"", 0, data]
        sighash = keccak256(rlp_encode(fields + [self.chain_id, b"", b""]))
        parity, r, s = sign(sighash, self.private_key)
        v = 35 + 2 * self.chain_id + parity
        raw = rlp_encode(fields + [v, r, s])
        txh = self._rpc("eth_sendRawTransaction", "0x" + raw.hex())
        receipt = None
        for _ in range(600):
            receipt = self._rpc("eth_getTransactionReceipt", txh)
            if receipt is not None:
                break
            import time

            time.sleep(0.2)
        if receipt is None:
            raise ValueError("no receipt")
        _print_receipt(receipt)
        if int(receipt["status"], 16) != 1:
            raise ValueError("transaction reverted")
        return receipt

    def deploy_contract(self, deployment_code: bytes) -> str:
        receipt = self._send_tx(None, deployment_code)
        addr = receipt["contractAddress"]
        print(f"Deployed to address: {addr}")
        return addr

    def submit_proof(self, contract_address: str, proof: bytes, instances):
        from .codegen import encode_calldata

        addr = bytes.fromhex(contract_address.removeprefix("0x"))
        self._send_tx(addr, encode_calldata(instances, proof))
