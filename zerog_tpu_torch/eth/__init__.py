"""EVM integration: verifier-contract codegen, a local EVM executor for gas
dry-runs, and a minimal JSON-RPC chain client.

Counterpart of ``zerog_tpu/eth/`` (the reference's `src/eth.rs`:
snark-verifier Yul codegen + revm + ethers). Host Python ints throughout:
nothing here touches a device, so it runs the same with or without a card.
"""

from .codegen import gen_evm_verifier, encode_calldata
from .evm import Evm

__all__ = ["gen_evm_verifier", "encode_calldata", "Evm", "dry_run_verifier"]


def dry_run_verifier(deployment_code: bytes, instances, proof: bytes) -> int:
    """Deploy + call the verifier on the local executor; returns gas used.
    Raises ValueError if the verifier reverts — mirrors
    `reference src/eth.rs:109-138`."""
    evm = Evm()
    caller = (0xFE).to_bytes(20, "big")
    dep = evm.deploy(caller, deployment_code)
    if not dep.success:
        raise ValueError("verifier deployment failed")
    res = evm.call(caller, dep.address, encode_calldata(instances, proof))
    if not res.success:
        raise ValueError("verifier reverted")
    return res.gas_used
