"""The 95th percentile over every view group of the window of the time from
its eval step's call until its 3D pose is on the host (host clock)."""

import numpy as np

LAYER, UNIT, MOVES, SOURCE = None, "ms", None, "host_clock"


def read(run):
    if run.kind != "infer" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
