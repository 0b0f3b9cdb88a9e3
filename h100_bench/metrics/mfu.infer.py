"""The eval forward's FLOPs (the reference's count of a group's views with
their others) over the groups of the `--trace 1` window before its traced
part, which the profiler slows, on the host clock, against the
configuration's published peak."""

LAYER, UNIT, MOVES, SOURCE = "Whole eval forward", "%", "infer_group_p95_ms", "host_clock"


def read(run):
    if run.kind != "infer" or run.trace is None or not run.untraced_steps:
        return None
    flops = run.forward_flops_per_item * run.items_per_step * run.untraced_steps
    return 100.0 * flops / (run.untraced_s * run.peak_flops)
