"""tables_s: seconds to have both window tables of the SRS in set-up, read
from the checkout's table cache or built (host clock, the card synchronized
before and after). Layer: set-up, files and keys."""


def read(run):
    return run.setup.get("tables_s")
