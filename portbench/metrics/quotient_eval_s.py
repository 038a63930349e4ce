"""quotient_eval_s: per-proof mean seconds of the program's ``quotient_eval``
mark (the constraint terms evaluated on the extended domain). Layer: prover."""


def read(run):
    return run.mark("quotient_eval")
