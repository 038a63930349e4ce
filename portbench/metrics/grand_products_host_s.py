"""grand_products_host_s: per-proof mean seconds of the program's span
``prover.grand_products`` (the permutation and lookup grand products: their
columns encoded, multiplied on the device and decoded), the
``grand_products_commit`` mark less the Z columns' commitments. Layer:
prover."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    span = trace.summary()["spans"].get("prover.grand_products")
    if span is None or not run.proofs:
        return None
    return span["seconds"] / run.proofs
