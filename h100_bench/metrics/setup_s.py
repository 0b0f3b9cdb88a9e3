"""Set-up: from the process's start to the first measured call, the
library's build (first run in a checkout), the model, the seed's weights
and inputs, and the warm-up and checked calls included."""

LAYER, UNIT, MOVES, SOURCE = None, "s", None, "host_clock"


def read(run):
    return run.setup_s
