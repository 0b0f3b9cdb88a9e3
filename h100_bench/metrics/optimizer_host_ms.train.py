"""Host milliseconds a train step inside the port's `train.optimizer` spans
(zero_grad and adam's step), over the traced part."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Host launch path", "ms", "train_samples_per_s", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None or not p.steps:
        return None
    return p.host_ms("train.optimizer") / p.steps
