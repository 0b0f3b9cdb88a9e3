"""`torch.cuda.max_memory_allocated` over the window, GiB."""

LAYER, UNIT, MOVES, SOURCE = None, "GiB", None, "host_clock"


def read(run):
    if run.kind != "train" or not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
