"""The share of the traced window in which the device ran nothing: one
minus the union of its kernels, copies and fills over the window."""

LAYER, UNIT, MOVES, SOURCE = "Device (H100)", "%", "train_samples_per_s", "device_trace"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
