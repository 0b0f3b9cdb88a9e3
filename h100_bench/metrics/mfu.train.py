"""The train step's model FLOPs (3x the reference's forward count: the
forward, and the backward's two products per forward product) over the
steps of the `--trace 1` window before its traced part, which the profiler
slows, on the host clock, against the configuration's published peak of
each card the step runs on."""

LAYER, UNIT, MOVES, SOURCE = "Whole train step", "%", "train_samples_per_s", "host_clock"


def read(run):
    if run.kind != "train" or run.trace is None or not run.untraced_steps:
        return None
    flops = 3 * run.forward_flops_per_item * run.items_per_step * run.untraced_steps
    return 100.0 * flops / (run.untraced_s * run.peak_flops * run.cards)
