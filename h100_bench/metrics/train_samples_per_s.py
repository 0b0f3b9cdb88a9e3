"""Items trained over the whole window (each a reference view with its
neighbour), over the window's host-clock seconds."""

LAYER, UNIT, MOVES, SOURCE = None, "samples/s", None, "host_clock"


def read(run):
    if run.kind != "train":
        return None
    return run.steps * run.items_per_step / run.window_s
