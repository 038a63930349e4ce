"""transfer_mib_per_proof: per-proof mean MiB of the program's counters
``h2d_bytes`` (host arrays handed to the device, as int64 limbs) and
``d2h_bytes`` (device tensors taken back to the host). Layer: host codec."""


def read(run):
    try:
        from zerog_tpu_torch import trace
    except ImportError:  # a program without counters
        return None
    counters = trace.summary()["counters"]
    found = [counters[n] for n in ("h2d_bytes", "d2h_bytes") if n in counters]
    if not found or not run.proofs:
        return None
    return sum(found) / run.proofs / 2 ** 20
