"""ntt_s: per-proof mean seconds of the program's ``quotient_ntts_adv_fix``
and ``quotient_ntts`` marks (the transforms to the extended domain). Layer:
poly/NTT."""


def read(run):
    return run.mark("quotient_ntts_adv_fix", "quotient_ntts")
