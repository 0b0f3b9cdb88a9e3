"""Host syncs a train step: the port's `host_syncs` counter (CUDA's sync
debug warnings) under its `train_step` spans, over the traced part's
steps.  None without a CUDA trace."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Host launch path", "syncs", "train_samples_per_s", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None or not p.steps or not run.trace.kernels:
        return None
    return p.counted("host_syncs", ["train_step"]) / p.steps
