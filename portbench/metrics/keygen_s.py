"""keygen_s: seconds of the proving key's generation in set-up (host clock,
the card synchronized before and after). Layer: set-up, files and keys."""


def read(run):
    return run.setup.get("keygen_s")
