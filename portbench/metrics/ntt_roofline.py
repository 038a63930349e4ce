"""ntt_roofline: the least time the NTT calls' inputs need over their device
time, in %. The least time is counted by the benchmark's yardstick from each
call's shape (``harness/yardstick.py``), whatever the program runs for it.
Layer: kernels."""

from harness import yardstick


def read(run):
    if run.trace is None:
        return None
    spent = run.device_s("ntt")
    if not spent:
        return None
    least = sum(yardstick.ntt_work(c["shape"])["least_s"] for c in run.calls("ntt"))
    return 100.0 * least / spent
