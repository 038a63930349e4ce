"""msm_device_ms: per-proof mean milliseconds of device time of every kernel
launched inside the MSM calls (``Srs.commit*``), from the profile. Layer:
curve/MSM."""


def read(run):
    if run.trace is None or not run.proofs:
        return None
    s = run.device_s("msm")
    return None if not s else 1e3 * s / run.proofs
