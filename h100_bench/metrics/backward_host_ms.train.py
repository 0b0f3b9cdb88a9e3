"""Host milliseconds a train step inside the port's `train.backward` span
(`loss.backward()`: autograd's enqueue of the backward), over the traced
part."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Host launch path", "ms", "train_samples_per_s", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None or not p.steps:
        return None
    return p.host_ms("train.backward") / p.steps
