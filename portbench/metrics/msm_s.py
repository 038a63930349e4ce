"""msm_s: per-proof mean wall seconds of the program's ``msm`` spans, one a
``Srs.commit*`` call from its entry until its points are on the host
(scalars encoded, the MSM's kernels, points decoded): the MSMs' time beside
their device time, ``msm_device_ms``. Layer: curve/MSM."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    span = trace.summary()["spans"].get("msm")
    if span is None or not run.proofs:
        return None
    return span["seconds"] / run.proofs
