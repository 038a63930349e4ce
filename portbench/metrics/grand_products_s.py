"""grand_products_s: per-proof mean seconds of the program's
``grand_products_commit`` mark (permutation and lookup grand products and
their commitments). Layer: prover."""


def read(run):
    return run.mark("grand_products_commit")
