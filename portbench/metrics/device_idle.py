"""device_idle: the share of the traced window in which no activity ran on
the card, in %: every kernel, copy and fill in the profile, their intervals
joined. Layer: device."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
