"""lookup_host_s: per-proof mean seconds of the program's spans
``prover.lookup_compress`` (the lookups' input and table expressions
evaluated and theta-compressed) and ``prover.lookup_permute`` (the permuted
pairs sorted and blinded): the host's part of the ``lookup_permute_commit``
mark. Layer: prover."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    spans = trace.summary()["spans"]
    found = [spans[n]["seconds"] for n in ("prover.lookup_compress", "prover.lookup_permute") if n in spans]
    if not found or not run.proofs:
        return None
    return sum(found) / run.proofs
