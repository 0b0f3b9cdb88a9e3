"""The share of the traced part's view groups that replayed the eval
forward's CUDA graph: the port's replay counter under its `eval_step` spans,
over those spans, in %.  None for a program that has no such counter (it
names it in `engine.tester.GRAPH_REPLAY_EVAL`), or without the port's
spans."""

import importlib

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Eval forward", "%", "infer_group_p95_ms", "program_counter"


def read(run):
    p = port_spans.of(run) if run.kind == "infer" else None
    if p is None or not p.steps:
        return None
    try:
        tester = importlib.import_module("epipolar_transformers_tpu_torch.engine.tester")
    except ImportError:
        return None
    counter = getattr(tester, "GRAPH_REPLAY_EVAL", None)
    if counter is None:
        return None
    return 100.0 * p.counted(counter, ["eval_step"]) / p.steps
