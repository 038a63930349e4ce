"""launches_per_proof: kernels the card ran in the traced window (the
program's own and torch's) per proof finished in it. Layer: device."""


def read(run):
    if run.trace is None or not run.proofs:
        return None
    return run.trace.kernels / run.proofs
