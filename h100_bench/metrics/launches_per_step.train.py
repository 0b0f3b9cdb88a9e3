"""Device kernels that started in the traced window, per train step."""

LAYER, UNIT, MOVES, SOURCE = "Host launch path", "launches", "train_samples_per_s", "device_trace"


def read(run):
    if run.kind != "train" or run.trace is None or not run.traced_steps:
        return None
    return run.trace.kernel_count() / run.traced_steps
