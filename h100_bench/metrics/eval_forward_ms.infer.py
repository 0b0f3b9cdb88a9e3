"""CUDA events around the benchmark's call of the eval step, mean over the
window's groups (device milliseconds from the call's first work to its last)."""

LAYER, UNIT, MOVES, SOURCE = "Eval forward", "ms", "infer_group_p95_ms", "program_span"


def read(run):
    if run.kind != "infer" or not run.eval_forward_ms:
        return None
    return sum(run.eval_forward_ms) / len(run.eval_forward_ms)
