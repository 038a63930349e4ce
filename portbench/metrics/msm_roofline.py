"""msm_roofline: the least time the MSM calls' inputs need over their device
time, in %. The least time is counted by the benchmark's yardstick from each
call's scalars and basis size (``harness/yardstick.py``), whatever the
program runs for it. Layer: kernels."""

from harness import yardstick


def read(run):
    if run.trace is None:
        return None
    spent = run.device_s("msm")
    if not spent:
        return None
    least = sum(yardstick.msm_work(yardstick.scalars_to_words(c["inputs"]),
                                   c["n_points"])["least_s"]
                for c in run.calls("msm"))
    return 100.0 * least / spent
