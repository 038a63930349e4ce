"""codec_s: per-proof mean seconds of the program's ``codec.encode``
(``to_limbs``) and ``codec.decode`` (``from_limbs``) spans, wherever they
nest: inside an MSM they count in ``msm_s`` too. A decode of device limbs
waits for the kernels that make them. Layer: host codec."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without spans
        return None
    spans = trace.summary()["spans"]
    found = [spans[n]["seconds"] for n in ("codec.encode", "codec.decode") if n in spans]
    if not found or not run.proofs:
        return None
    return sum(found) / run.proofs
