"""to_limbs_s: per-proof mean seconds of the program's
``quotient_host_to_limbs`` and ``quotient_aux_to_limbs`` marks (host values
into device limbs). Layer: host codec."""


def read(run):
    return run.mark("quotient_host_to_limbs", "quotient_aux_to_limbs")
