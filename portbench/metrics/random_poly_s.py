"""random_poly_s: per-proof mean seconds of the program's span
``prover.random_poly``: the random polynomial's 2^k blinding draws on the
host, the host's part of the ``random_poly_commit`` mark. Layer: prover."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    span = trace.summary()["spans"].get("prover.random_poly")
    if span is None or not run.proofs:
        return None
    return span["seconds"] / run.proofs
