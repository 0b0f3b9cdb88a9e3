"""Device milliseconds a train step of the epipolar attention's kernels:
the CUDA events of the port's `epipolar.attention` and
`epipolar.attention_backward` device spans, over the traced part's steps."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Attention kernels", "ms", "train_samples_per_s", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None or not p.steps:
        return None
    ms = p.device_ms(["epipolar.attention", "epipolar.attention_backward"])
    return None if ms is None else ms / p.steps
