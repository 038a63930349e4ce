"""field_ops_per_proof: per-proof mean of the program's counter
``field_ops``, one a call of a public ``JField`` op: the field arithmetic
that the program runs as torch launches on the card (quotient, grand
products, evaluations, opening). Layer: kernels."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without counters
        return None
    n = trace.summary()["counters"].get("field_ops")
    if n is None or not run.proofs:
        return None
    return n / run.proofs
