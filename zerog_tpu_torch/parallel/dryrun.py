"""The mesh proving step end to end on a toy circuit: the counterpart of
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``.

    python -m zerog_tpu_torch.parallel.dryrun N [DEVICE ...]

proves the toy circuit at k = 6 on an N-entry mesh (every commitment through
the point-sharded merged-window MSM, the four-step NTTs, the row-sharded
quotient, the GWC multiopen), asserts that the proof's bytes equal the
single-device proof's under the same seed, verifies it, and prints the
analytic per-proof communication of the sharded paths (``scaling_proxy``).
With no devices the mesh is N of the CUDA cards; ``cuda:0`` given N times
runs N entries on one card, ``cpu`` N times runs them on the host.
"""

from __future__ import annotations

import json
import sys

__all__ = ["dryrun_multichip"]


class _ToyCircuit:
    """a*b = c (public) with a nibble-range lookup on a — tiny but exercising
    gates, lookups, copies and the instance column."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def configure(self, cs):
        col_a, col_b, col_c = (cs.advice_column() for _ in range(3))
        sel, q_look = cs.selector(), cs.selector()
        table = cs.lookup_table_column()
        instance = cs.instance_column()
        for col in (col_a, col_b, col_c, instance):
            cs.enable_equality(col)
        cs.create_gate("mul", [sel.expr() * (col_a.cur() * col_b.cur() - col_c.cur())])
        cs.lookup("a_nibble", [(q_look.expr() * col_a.cur(), table)])
        return dict(a=col_a, b=col_b, c=col_c, sel=sel, table=table,
                    q_look=q_look, instance=instance)

    def synthesize(self, cfg, asn):
        from ..field import FR

        asn.assign_table([cfg["table"]], [list(range(16))])
        row = asn.region([cfg["a"], cfg["b"], cfg["c"], cfg["sel"], cfg["q_look"]], 1)
        (ca,) = asn.assign_advice(cfg["a"], row, self.a % FR.p)
        asn.assign_advice(cfg["b"], row, self.b % FR.p)
        (cc,) = asn.assign_advice(cfg["c"], row, self.a * self.b % FR.p)
        asn.enable_selector(cfg["sel"], row)
        asn.enable_selector(cfg["q_look"], row)
        row2 = asn.region([cfg["b"]], 1)
        (cb2,) = asn.assign_advice(cfg["b"], row2, self.a % FR.p)
        asn.copy(ca, cb2)
        asn.constrain_instance(cc, cfg["instance"], 0)


def _analytic_comm(n_devices: int, pk, proof_len: int) -> dict:
    """Analytic per-proof communication volumes of the sharded paths, in the
    port's tensors (16 limbs of 8 bytes a field element): the MSM's
    per-entry Jacobian partial sums (3 coordinates) and one all_to_all
    transpose of the whole array per four-step transform (~6 of n rows and
    ~4 of extended_n rows a proof). Pure host arithmetic."""
    k = pk.vk.k
    n = 1 << k
    cs = pk.vk.cs
    domain_ext_n = n * (1 << max(0, (cs.degree() - 2).bit_length()))
    d = n_devices
    commits = (cs.num_advice + 2 * len(cs.lookups) + cs.num_permutation_chunks()
               + len(cs.lookups) + 1 + (cs.degree() - 1)
               + len({rot for _, rot in cs.advice_queries()}))
    element_bytes = 16 * 8
    msm_comm = commits * d * 3 * element_bytes
    ntt_comm = (6 * n + 4 * domain_ext_n) * element_bytes * (d - 1) // d
    return {
        "devices": d,
        "msm_partial_sum_bytes_per_proof": msm_comm,
        "ntt_all_to_all_bytes_per_proof": ntt_comm,
        "proof_bytes": proof_len,
    }


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Prove and verify the toy circuit at k = 6 on an `n_devices`-entry mesh
    of `devices` (None: the CUDA cards); the proof's bytes must equal the
    single-device proof's. Prints a line of text and the ``scaling_proxy``
    JSON line, and returns the proxy."""
    from ..curve import Srs
    from ..plonk import create_proof, keygen, verify_proof
    from .mesh import make_mesh

    mesh = make_mesh(n_devices, devices)
    k = 6
    srs = Srs.setup(k, seed=b"dryrun-srs", device=mesh[0])
    pk = keygen(_ToyCircuit(0, 0), k, srs)
    proof = create_proof(pk, srs, _ToyCircuit(3, 5), [[15]], rng_seed=b"dryrun",
                         mesh=mesh)
    single = create_proof(pk, srs, _ToyCircuit(3, 5), [[15]], rng_seed=b"dryrun")
    if proof != single:
        raise AssertionError("the mesh proof's bytes differ from the "
                             "single-device proof's")
    if not verify_proof(pk.vk, srs, [[15]], proof):
        raise AssertionError("the mesh proof did not verify")
    print(f"dryrun_multichip({n_devices}): full mesh proving step OK on "
          f"{[str(d) for d in mesh]} — sharded fixed-base MSM commitments + "
          f"four-step NTT + row-sharded quotient; {len(proof)}-byte proof, "
          f"equal to the single-device proof, verified", flush=True)
    proxy = _analytic_comm(n_devices, pk, len(proof))
    print(json.dumps({"scaling_proxy": proxy}), flush=True)
    return proxy


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m zerog_tpu_torch.parallel.dryrun N [DEVICE ...]")
    dryrun_multichip(int(sys.argv[1]), sys.argv[2:] or None)
