"""Proof creation — counterpart of ``zerog_tpu/plonk/prover.py`` (halo2's
`create_proof`).

Host/device split: commitments (MSM), NTTs and the quotient evaluation run on
the device; transcripts, sorting and witness synthesis stay on host.

Phases:
  1. absorb vk digest + public instance values
  2. synthesize witness, randomize blinding rows, commit advice       [MSM]
  3. theta; lookup permuted pairs, commit                             [MSM]
  4. beta, gamma; permutation + lookup grand products, commit         [MSM]
  5. random poly commit; y
  6. quotient h on the extended coset domain                          [NTT+eval]
     split and commit pieces                                          [MSM]
  7. x; write all evaluations
  8. GWC multiopen                                                    [MSM]

The quotient's expression trees are evaluated eagerly, op by op, in exact
verifier order.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from .. import trace
from ..field import FR, jfr, to_limbs, to_device
from ..parallel.mesh import gather, mesh_key, shard_axis
from ..poly.domain import Domain, get_domain
from ..transcript import KeccakTranscriptWriter
from .assignment import Assignment
from .cs import ConstraintSystem
from .expression import evaluate
from .hostops import make_host_ops
from .keygen import ProvingKey
from .lookup import compress, commit_permuted, grand_product
from .permutation import grand_products

__all__ = ["Drbg", "PHASES", "create_proof"]

# the phases of a proof, in order: the spans ``phase.<name>`` and the keys of
# create_proof's `timings`
PHASES = ("synthesize", "commit_advice", "lookup_permute_commit",
          "grand_products_commit", "random_poly_commit", "quotient_host_to_limbs",
          "quotient_ntts_adv_fix", "quotient_aux_to_limbs", "quotient_ntts",
          "quotient_eval", "quotient", "evals_dinv", "evals_bary", "evals",
          "multiopen")


def _hc_fold(h_stack, xn_limbs):
    """Horner fold of the quotient pieces: sum_i xn^i * h_i."""
    f = jfr()
    acc = h_stack[-1]
    for i in range(h_stack.shape[0] - 2, -1, -1):
        acc = f.add(f.mul(acc, xn_limbs), h_stack[i])
    return acc


class Drbg:
    """Deterministic blinding RNG (blake2b counter mode). Seed None -> OS
    entropy; a fixed seed gives bit-reproducible proofs (the halo2 API is
    generic over RngCore for the same reason)."""

    def __init__(self, seed: bytes | None = None):
        self.seed = seed if seed is not None else os.urandom(32)
        self.counter = 0

    def field(self) -> int:
        while True:
            h = hashlib.blake2b(
                self.seed + self.counter.to_bytes(8, "little"), digest_size=32
            ).digest()
            self.counter += 1
            v = int.from_bytes(h, "little")
            if v >> 254 == 0 and v % FR.p == v:
                return v


class _Marks:
    """The proof's phases: ``mark(name)`` ends the phase `name` of PHASES
    and starts the next. Each phase is the span ``phase.<name>``
    (:class:`zerog_tpu_torch.trace.Phases`) and, where `timings` is given,
    its seconds there, summed, with the device synchronized at each mark so
    that a phase's time includes the kernels it queued."""

    def __init__(self, timings, device):
        self.timings = timings
        self.sync = device if timings is not None and device.type == "cuda" else None
        self.phases = trace.Phases("phase.", PHASES)
        self.last = None

    def __enter__(self):
        t = self.phases.start()
        if self.timings is not None:
            self.last = t or time.time_ns()
        return self

    def __call__(self, name):
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        t = self.phases.mark(name)
        if self.timings is not None:
            t = t or time.time_ns()
            self.timings[name] = self.timings.get(name, 0.0) + (t - self.last) / 1e9
            self.last = t

    def __exit__(self, *exc):
        self.phases.stop()
        return False


def _to_dev_lagrange(columns, device):
    """list of object arrays [n] -> mont limb tensor [C, n, 16] on `device`."""
    arr = np.stack([to_limbs(np.asarray(c, dtype=object) % FR.p, FR, mont=True) for c in columns])
    return to_device(arr, device)


class _Ext:
    """Extended-domain forms of the witness-independent selector polys."""

    def __init__(self, domain: Domain, cs: ConstraintSystem):
        self.domain = domain
        self.cs = cs
        f = jfr()
        dev = domain.device
        n, n_ext = domain.n, domain.extended_n
        u = cs.usable_rows(n)
        self.u = u
        # lagrange selector polys on extended domain
        l0 = np.zeros(n, dtype=object); l0[0] = 1
        llast = np.zeros(n, dtype=object); llast[u] = 1
        lblind = np.zeros(n, dtype=object); lblind[u + 1 :] = 1
        self.l0, self.l_last, self.l_blind = self.lagrange_to_ext(
            _to_dev_lagrange([l0, llast, lblind], dev))
        one = f._c("one_mont", dev)
        self.l_active = f.sub(f.sub(one.expand(n_ext, 16), self.l_last),
                              self.l_blind)
        # X values on the extended coset
        xs = []
        cur = domain.g_coset
        for _ in range(n_ext):
            xs.append(cur)
            cur = cur * domain.extended_omega % FR.p
        self.x_ext = to_device(to_limbs(xs, FR, mont=True), dev)

    def lagrange_to_ext(self, dev_lagrange):
        coeffs = self.domain.lagrange_to_coeff(dev_lagrange)
        return self.domain.coeff_to_extended(coeffs)

    def const(self, c: int):
        return to_device(to_limbs(c % FR.p, FR, mont=True), self.domain.device)


class _EnvOps:
    """Expression ops over the env dictionary of extended-domain tensors."""

    def __init__(self, env, domain, device):
        self.env = env
        self.domain = domain
        self.device = device
        self.f = jfr()
        self._consts = {}

    def rot(self, key, index, rotation):
        """Row `index` of env[key], rotated by `rotation` base-domain steps."""
        arr = self.env[key][index]
        if rotation == 0:
            return arr
        return self.domain.rotate_extended(arr, rotation)

    def constant(self, c):
        v = self._consts.get(c)
        if v is None:
            v = self._consts[c] = to_device(
                to_limbs(c % FR.p, FR, mont=True), self.device)
        return v

    def fixed(self, col, rot):
        return self.rot("fix", col, rot)

    def advice(self, col, rot):
        return self.rot("adv", col, rot)

    def instance(self, col, rot):
        return self.rot("inst", col, rot)

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def mul(self, a, b):
        return self.f.mul(a, b)

    def scale(self, a, s):
        return self.f.mul(a, self.constant(s))

    def col(self, column):
        if column.kind == "advice":
            return self.env["adv"][column.index]
        if column.kind == "fixed":
            return self.env["fix"][column.index]
        return self.env["inst"][column.index]


class _ShardOps(_EnvOps):
    """The ops of mesh entry `e` over its row block of every extended-domain
    tensor: a rotation reads the rows it needs from the neighbouring blocks
    (``ShardedDomain.rotate_extended_sharded``)."""

    def __init__(self, envs, e, domain, device):
        super().__init__(envs[e], domain, device)
        self.envs = envs
        self.e = e

    def rot(self, key, index, rotation):
        if rotation == 0:
            return self.env[key][index]
        return self.domain.rotate_extended_sharded(
            [env[key][index] for env in self.envs], self.e, rotation)


def _quotient_term_fns(cs, bf):
    """fn(ops, env) -> term tensor | list of terms, for every quotient
    constraint term, in exact verifier order. All field math goes through
    `ops`."""
    term_fns = []

    for gname, polys in cs.gates:
        for poly in polys:
            term_fns.append(lambda ops, env, poly=poly: evaluate(poly, ops))

    if cs.permutation_columns:
        chunk = cs.permutation_chunk_len()
        num_sets = cs.num_permutation_chunks()

        def perm_l0(ops, env):
            one = env["one"]
            return ops.mul(env["l0"], ops.sub(one, env["perm_z"][0]))

        term_fns.append(perm_l0)

        def perm_llast(ops, env):
            zl = env["perm_z"][num_sets - 1]
            return ops.mul(env["l_last"], ops.sub(ops.mul(zl, zl), zl))

        term_fns.append(perm_llast)

        for i in range(1, num_sets):
            def perm_chain(ops, env, i=i):
                prev = ops.rot("perm_z", i - 1, -(bf + 1))
                return ops.mul(env["l0"], ops.sub(env["perm_z"][i], prev))

            term_fns.append(perm_chain)

        for si, start in enumerate(range(0, len(cs.permutation_columns), chunk)):
            cols = cs.permutation_columns[start : start + chunk]

            def perm_prod(ops, env, si=si, cols=cols, start=start):
                left = ops.rot("perm_z", si, 1)
                right = env["perm_z"][si]
                for j, col in enumerate(cols, start=start):
                    ve = ops.col(col)
                    sig = env["sigma"][j]
                    left = ops.mul(
                        left,
                        ops.add(ops.add(ve, ops.mul(env["beta"], sig)),
                                env["gamma"]))
                    right = ops.mul(
                        right,
                        ops.add(ops.add(ve, ops.mul(env["beta_delta"][j],
                                                    env["x_ext"])),
                                env["gamma"]),
                    )
                return ops.mul(env["l_active"], ops.sub(left, right))

            term_fns.append(perm_prod)

    for li, (lname, pairs) in enumerate(cs.lookups):
        def lookup_terms(ops, env, li=li, pairs=pairs):
            # returns the 5 terms of this lookup, in verifier order
            one = env["one"]
            z = env["lookup_z"][li]
            z_next = ops.rot("lookup_z", li, 1)
            a_perm = env["lk_aux"][2 * li]
            s_perm = env["lk_aux"][2 * li + 1]

            def fold(exprs):
                acc = None
                for e in exprs:
                    v = evaluate(e, ops)
                    if v.dim() == 1:
                        v = v.expand(a_perm.shape)
                    acc = v if acc is None else ops.add(ops.mul(acc, env["theta"]), v)
                return acc

            a_comp = fold([e for e, _ in pairs])
            s_comp = fold([t for _, t in pairs])
            t1 = ops.mul(env["l0"], ops.sub(one, z))
            t2 = ops.mul(env["l_last"], ops.sub(ops.mul(z, z), z))
            lhs = ops.mul(z_next, ops.mul(ops.add(a_perm, env["beta"]),
                                          ops.add(s_perm, env["gamma"])))
            rhs = ops.mul(z, ops.mul(ops.add(a_comp, env["beta"]),
                                     ops.add(s_comp, env["gamma"])))
            t3 = ops.mul(env["l_active"], ops.sub(lhs, rhs))
            t4 = ops.mul(env["l0"], ops.sub(a_perm, s_perm))
            a_prev = ops.rot("lk_aux", 2 * li, -1)
            t5 = ops.mul(env["l_active"],
                         ops.mul(ops.sub(a_perm, s_perm),
                                 ops.sub(a_perm, a_prev)))
            return [t1, t2, t3, t4, t5]

        term_fns.append(lookup_terms)

    return term_fns


def _eval_quotient(term_fns, ops, h):
    """h <- h*y + term for every quotient term, in exact verifier order."""
    f = ops.f
    env = ops.env
    for fn in term_fns:
        out = fn(ops, env)
        terms = out if isinstance(out, list) else [out]
        for t in terms:
            if t.dim() == 1:
                t = t.expand(h.shape)
            h = f.add(f.mul(h, env["y"]), t)
    return h


def create_proof(pk: ProvingKey, srs, circuit, instances, rng_seed=None,
                 transcript=None, debug=None, timings=None, device=None,
                 mesh=None):
    """instances: list of per-column public value lists. Returns proof bytes.

    `device=None` means the SRS's device (the CUDA card unless the SRS was
    made for the CPU); a device that differs from the SRS's is refused.

    `mesh`: optional :class:`zerog_tpu_torch.parallel.Mesh` whose first
    entry is the SRS's device. Commitment MSMs shard the points over its
    entries (``ShardedSrs``), the NTTs run the four-step decomposition
    (``ShardedDomain``) and the quotient is evaluated on row blocks, one an
    entry. All arithmetic is exact, so the proof bytes are those of the
    single-device path under the same seed.

    `timings`: optional dict filled with the wall seconds of each phase of
    PHASES, the synchronized view of the phase spans ``phase.<name>`` of
    :mod:`zerog_tpu_torch.trace`: where it is given on a CUDA device, the
    device is synchronized at the end of each phase, so each phase's time
    includes the kernels it queued. The spans alone synchronize nothing.
    """
    from ..device import resolve_device

    if mesh is not None:
        from ..parallel.sharded_prover import ShardedSrs

        if not isinstance(srs, ShardedSrs):
            srs = ShardedSrs(srs, mesh)
    device = srs.device if device is None else resolve_device(device)
    if device != srs.device:
        raise ValueError(f"create_proof: device {device} differs from the "
                         f"SRS's device {srs.device}")
    with trace.proof(), _Marks(timings, device) as mark:
        return _prove(pk, srs, circuit, instances, rng_seed, transcript, debug,
                      mark, device, mesh)


def _prove(pk, srs, circuit, instances, rng_seed, transcript, debug, _mark,
           device, mesh):
    """The body of :func:`create_proof`; `_mark(name)` ends a phase."""
    vk = pk.vk
    cs = vk.cs
    k = vk.k
    n = 1 << k
    domain = get_domain(k, cs.degree(), device=device)
    if mesh is not None:
        domain = _sharded_domain(domain, mesh)
    mkey = None if mesh is None else mesh_key(mesh)
    usable = cs.usable_rows(n)
    bf = cs.blinding_factors()
    rng = Drbg(rng_seed)
    transcript = transcript if transcript is not None else KeccakTranscriptWriter()
    p = FR.p

    # ---- phase 0: bind vk + instances ------------------------------------
    transcript.common_scalar(vk.transcript_repr)
    for col_vals in instances:
        for v in col_vals:
            transcript.common_scalar(int(v) % p)

    inst_padded = [
        np.asarray(list(col) + [0] * (n - len(col)), dtype=object) for col in instances
    ]
    while len(inst_padded) < cs.num_instance:
        inst_padded.append(np.zeros(n, dtype=object))

    # ---- phase 1: witness + advice commitments ---------------------------
    cs2 = ConstraintSystem()
    config = circuit.configure(cs2)
    assert cs2.num_advice == cs.num_advice
    asn = Assignment(cs2, n)
    circuit.synthesize(config, asn)
    with trace.span("frontend.finalize"):
        asn.finalize_tables()
        if cs.compression is not None:
            # re-apply the keygen-recorded selector compression to the freshly
            # synthesized fixed columns so they match vk.cs's layout
            from .selectors import apply_to_fixed

            asn.fixed = apply_to_fixed(cs.compression, asn.fixed, n)
    assert len(asn.fixed) == cs.num_fixed
    advice = asn.advice
    with trace.span("prover.blind"):
        for col in advice:
            for i in range(usable, n):
                col[i] = rng.field()

    _mark("synthesize")
    advice_coms = srs.commit_lagrange([list(c) for c in advice])
    for com in advice_coms:
        transcript.write_point(com)

    _mark("commit_advice")
    theta = transcript.squeeze_challenge()

    # ---- phase 2: lookup permuted pairs ----------------------------------
    host_ops = make_host_ops(asn, inst_padded)

    def full_col(v):
        v = np.asarray(v, dtype=object)
        if v.ndim == 0:
            return np.full(n, v[()], dtype=object)
        return v

    lookups = []
    for name, pairs in cs.lookups:
        with trace.span("prover.lookup_compress"):
            a = compress([full_col(evaluate(i, host_ops)) for i, _ in pairs], theta)
            s = compress([full_col(evaluate(t, host_ops)) for _, t in pairs], theta)
        with trace.span("prover.lookup_permute"):
            lc = commit_permuted(a, s, usable, rng)
        lookups.append(lc)
    if lookups:
        coms = srs.commit_lagrange(
            [list(lc.permuted_input) for lc in lookups]
            + [list(lc.permuted_table) for lc in lookups]
        )
        for i, lc in enumerate(lookups):
            transcript.write_point(coms[i])                 # A'
            transcript.write_point(coms[len(lookups) + i])  # S'

    _mark("lookup_permute_commit")
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # ---- phase 3: grand products -----------------------------------------
    def column_values(col):
        if col.kind == "advice":
            return advice[col.index]
        if col.kind == "fixed":
            return asn.fixed[col.index]
        return inst_padded[col.index]

    with trace.span("prover.grand_products"):
        perm_vals = [column_values(c) for c in cs.permutation_columns]
        perm_zs = grand_products(
            perm_vals, pk.sigma_values, beta, gamma, usable, n,
            cs.permutation_chunk_len(), rng, device,
        )
        lookup_zs = [grand_product(lc, beta, gamma, usable, rng, device)
                     for lc in lookups]

    z_coms = srs.commit_lagrange(
        [list(z) for z in perm_zs] + [list(z) for z in lookup_zs]
    ) if (perm_zs or lookup_zs) else []
    for com in z_coms[: len(perm_zs)]:
        transcript.write_point(com)
    for com in z_coms[len(perm_zs) :]:
        transcript.write_point(com)

    # ---- phase 4: vanishing random poly ----------------------------------
    _mark("grand_products_commit")
    with trace.span("prover.random_poly"):
        random_poly = np.asarray([rng.field() for _ in range(n)], dtype=object)
    transcript.write_point(srs.commit(list(random_poly)))

    _mark("random_poly_commit")
    y = transcript.squeeze_challenge()

    # ---- phase 5: quotient on extended domain (device) --------------------
    # The extended-domain environment (_Ext: l0/l_last/l_active/x_ext) and
    # the fixed/sigma column forms are witness-INDEPENDENT, so they are
    # computed once per pk, device and mesh and cached.
    static_key = ("ext_static", str(device), mkey)
    static = pk._cache.get(static_key)
    if static is None:
        ext = _Ext(domain, cs)
        fix_lag = _to_dev_lagrange(asn.fixed, device) if asn.fixed else None
        fix_ext = (domain.coeff_to_extended(domain.lagrange_to_coeff(fix_lag))
                   if asn.fixed else None)
        sigma_lag = (_to_dev_lagrange(pk.sigma_values, device)
                     if pk.sigma_values else None)
        sigma_ext = (
            domain.coeff_to_extended(domain.lagrange_to_coeff(sigma_lag))
            if pk.sigma_values else None)
        static = (ext, fix_lag, fix_ext, sigma_lag, sigma_ext)
        pk._cache[static_key] = static
    ext, fix_lag, fix_ext, sigma_lag, sigma_ext = static

    adv_lag = _to_dev_lagrange(advice, device) if advice else None
    inst_lag = _to_dev_lagrange(inst_padded, device) if inst_padded else None
    _mark("quotient_host_to_limbs")

    adv_coeff = domain.lagrange_to_coeff(adv_lag) if advice else None
    inst_coeff = domain.lagrange_to_coeff(inst_lag) if inst_padded else None

    adv_ext = domain.coeff_to_extended(adv_coeff) if advice else None
    inst_ext = domain.coeff_to_extended(inst_coeff) if inst_padded else None

    _mark("quotient_ntts_adv_fix")

    zs_all = list(perm_zs) + list(lookup_zs)
    lk_polys = []
    for lc in lookups:
        lk_polys.extend([lc.permuted_input, lc.permuted_table])
    aux_lag = (_to_dev_lagrange(zs_all + lk_polys, device)
               if (zs_all or lk_polys) else None)
    _mark("quotient_aux_to_limbs")
    aux_coeff = domain.lagrange_to_coeff(aux_lag) if aux_lag is not None else None
    aux_ext = domain.coeff_to_extended(aux_coeff) if aux_lag is not None else None

    perm_z_ext = [aux_ext[i] for i in range(len(perm_zs))]
    lookup_z_ext = [aux_ext[len(perm_zs) + i] for i in range(len(lookup_zs))]
    base = len(zs_all)

    env = dict(
        adv=adv_ext, fix=fix_ext, inst=inst_ext,
        sigma=sigma_ext,
        perm_z=torch.stack(perm_z_ext) if perm_z_ext else None,
        lookup_z=torch.stack(lookup_z_ext) if lookup_z_ext else None,
        lk_aux=aux_ext[base:] if len(lookups) else None,  # [2*L, n_ext, 16]
        l0=ext.l0, l_last=ext.l_last, l_active=ext.l_active, x_ext=ext.x_ext,
        theta=ext.const(theta), beta=ext.const(beta), gamma=ext.const(gamma),
        y=ext.const(y), one=ext.const(1),
        # beta * delta^j, per global permutation column index
        beta_delta=torch.stack([
            ext.const(pow(FR.delta, j, p) * beta % p)
            for j in range(len(cs.permutation_columns))
        ]) if cs.permutation_columns else None,
    )

    _mark("quotient_ntts")
    term_key = ("quotient_term_fns", mkey)
    term_fns = pk._cache.get(term_key)
    if term_fns is None:
        term_fns = pk._cache[term_key] = _quotient_term_fns(cs, bf)

    n_ext = domain.extended_n
    if mesh is None:
        h_ext = torch.zeros((n_ext, 16), dtype=torch.int64, device=device)
        h_ext = _eval_quotient(term_fns, _EnvOps(env, domain, device), h_ext)
    else:
        # row-shard the extended domain: entry e evaluates every term on its
        # block of rows (the rest of the env is copied to each entry); h_ext
        # is gathered before the vanishing division
        def parts(val):
            if val is not None and val.dim() >= 2 and val.shape[-2] == n_ext:
                return shard_axis(mesh, val, axis=-2)
            return [None if val is None else val.to(dev) for dev in mesh]

        by_key = {key: parts(val) for key, val in env.items()}
        envs = [{key: p[e] for key, p in by_key.items()}
                for e in range(len(mesh))]
        h_ext = gather([
            _eval_quotient(term_fns, _ShardOps(envs, e, domain, dev),
                           torch.zeros((n_ext // len(mesh), 16),
                                       dtype=torch.int64, device=dev))
            for e, dev in enumerate(mesh)], axis=0, device=device)
    _mark("quotient_eval")
    h_ext = domain.divide_by_vanishing_poly(h_ext)
    if debug is not None:
        debug["h_ext"] = h_ext
    h_coeff_dev = domain.extended_to_coeff(h_ext)
    num_pieces = domain.quotient_poly_degree
    h_stack = h_coeff_dev[: num_pieces * n].reshape(num_pieces, n, 16)
    h_coms = srs.commit_dev(h_stack)
    for com in h_coms:
        transcript.write_point(com)

    _mark("quotient")
    x = transcript.squeeze_challenge()

    # ---- phase 6: evaluations (barycentric, on the device) -----------------
    # One Lagrange-form stack holds every queried polynomial; all openings
    # are batched barycentric evaluations sharing one batch inversion.
    from ..poly.eval import barycentric_eval, domain_inverses

    xn = pow(x, n, p)
    # h_combined = sum xn^i h_i, folded on device in coefficient form
    xn_limbs = ext.const(xn)
    hc_coeff = _hc_fold(h_stack, xn_limbs)
    random_coeff_dev = to_device(
        to_limbs(np.asarray(random_poly, dtype=object), FR, mont=True), device)
    tail_lag = domain.coeff_to_lagrange(
        torch.stack([random_coeff_dev, hc_coeff]))

    parts = []
    base = 0

    def push(arr):
        nonlocal base
        parts.append(arr)
        b = base
        base += arr.shape[0]
        return b

    adv_base = push(adv_lag) if advice else 0
    fix_base = push(fix_lag) if asn.fixed else 0
    sigma_base = push(sigma_lag) if pk.sigma_values else 0
    aux_base = push(aux_lag) if aux_lag is not None else 0
    lk_base = aux_base + len(zs_all)
    random_row = push(tail_lag[:1])
    hc_row = push(tail_lag[1:])
    lag_stack = torch.cat(parts, dim=0)

    # (row, rotation) for every transcript eval, in write order
    eval_specs = []
    for col, rot in cs.advice_queries():
        eval_specs.append((adv_base + col, rot))
    for col, rot in cs.fixed_queries():
        eval_specs.append((fix_base + col, rot))
    eval_specs.append((random_row, 0))
    for j in range(len(pk.sigma_values or [])):
        eval_specs.append((sigma_base + j, 0))
    for i in range(len(perm_zs)):
        eval_specs.append((aux_base + i, 0))
        eval_specs.append((aux_base + i, 1))
    for i in range(len(perm_zs) - 2, -1, -1):
        eval_specs.append((aux_base + i, -(bf + 1)))
    for i in range(len(lookups)):
        zrow = aux_base + len(perm_zs) + i
        arow = lk_base + 2 * i
        srow = lk_base + 2 * i + 1
        eval_specs.extend([
            (zrow, 0), (zrow, 1), (arow, 0), (arow, -1), (srow, 0),
        ])

    rot_order = []
    for _, rot in eval_specs:
        if rot not in rot_order:
            rot_order.append(rot)
    zs = [domain.rotate_point(x, rot) for rot in rot_order]
    dinv, _ = domain_inverses(domain.k, zs, device)
    _mark("evals_dinv")
    evals_by_point = barycentric_eval(domain.k, lag_stack, zs, dinv)
    _mark("evals_bary")
    rot_idx = {rot: i for i, rot in enumerate(rot_order)}
    eval_of = {}
    for row, rot in eval_specs:
        eval_of[(row, rot)] = evals_by_point[rot_idx[rot]][row]
        transcript.write_scalar(eval_of[(row, rot)])

    # ---- phase 7: multiopen (device Kate division) -------------------------
    from .gwc import DeviceQuery, multiopen_prove_device

    def dq(row, rot):
        return DeviceQuery(row, rot, eval_of[(row, rot)])

    # h_combined's eval is derived, not independently written
    hc_eval = 0
    queries = []
    for col, rot in cs.advice_queries():
        queries.append(dq(adv_base + col, rot))
    for i in range(len(perm_zs)):
        queries.append(dq(aux_base + i, 0))
        queries.append(dq(aux_base + i, 1))
    for i in range(len(perm_zs) - 2, -1, -1):
        queries.append(dq(aux_base + i, -(bf + 1)))
    for i in range(len(lookups)):
        zrow = aux_base + len(perm_zs) + i
        arow = lk_base + 2 * i
        srow = lk_base + 2 * i + 1
        queries.append(dq(zrow, 0))
        queries.append(dq(arow, 0))
        queries.append(dq(srow, 0))
        queries.append(dq(arow, -1))
        queries.append(dq(zrow, 1))
    for col, rot in cs.fixed_queries():
        queries.append(dq(fix_base + col, rot))
    for j in range(len(pk.sigma_values or [])):
        queries.append(dq(sigma_base + j, 0))
    hc_eval = _bary_single(domain, lag_stack[hc_row], x, dinv[rot_idx[0]])
    queries.append(DeviceQuery(hc_row, 0, hc_eval))
    queries.append(dq(random_row, 0))

    if debug is not None:
        debug["ext_helper"] = ext
        debug.update(dict(
            advice=advice, fixed=asn.fixed, inst=inst_padded, lookups=lookups,
            perm_zs=perm_zs, lookup_zs=lookup_zs, random_poly=random_poly,
            theta=theta, beta=beta, gamma=gamma, y=y, x=x,
            domain=domain, cs=cs, usable=usable, bf=bf,
            sigma_values=pk.sigma_values, lag_stack=lag_stack,
            eval_of=eval_of,
        ))

    _mark("evals")
    multiopen_prove_device(queries, lag_stack, x, domain, srs, transcript)

    _mark("multiopen")
    return transcript.finalize()


_SHARDED_DOMAINS: dict = {}


def _sharded_domain(domain, mesh):
    """The ShardedDomain of (k, extended k, mesh), cached: its four-step
    plans and twiddles persist across proofs."""
    key = (domain.k, domain.extended_k, mesh_key(mesh))
    sd = _SHARDED_DOMAINS.get(key)
    if sd is None:
        from ..parallel.sharded_domain import ShardedDomain

        sd = _SHARDED_DOMAINS[key] = ShardedDomain(domain, mesh)
    return sd


def _bary_single(domain, row, z: int, dinv_row):
    """Barycentric evaluation of one Lagrange row at z (shares the batched
    domain inverses)."""
    from ..poly.eval import barycentric_eval

    return barycentric_eval(domain.k, row[None], [z], dinv_row[None])[0][0]
