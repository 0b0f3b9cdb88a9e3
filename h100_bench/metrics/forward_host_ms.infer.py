"""Host milliseconds a view group inside the port's `eval.forward` span (the
model call: enqueuing the eval forward), over the traced part."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Eval forward", "ms", "infer_group_p95_ms", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "infer" else None
    if p is None or not p.steps:
        return None
    return p.host_ms("eval.forward") / p.steps
