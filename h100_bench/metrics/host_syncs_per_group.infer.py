"""Host syncs a view group: the port's `host_syncs` counter (CUDA's sync
debug warnings) under its `eval_step`, `eval.fetch` and
`eval.process_group` spans, over the traced part's groups.  None without a
CUDA trace."""

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Eval forward", "syncs", "infer_group_p95_ms", "program_span"


def read(run):
    p = port_spans.of(run) if run.kind == "infer" else None
    if p is None or not p.steps or not run.trace.kernels:
        return None
    return p.counted("host_syncs", ["eval_step", "eval.fetch", "eval.process_group"]) / p.steps
