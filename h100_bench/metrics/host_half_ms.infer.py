"""The host clock around the benchmark's call of `process_group` (with the
copies' hand-over to numpy), mean over the window's groups."""

LAYER, UNIT, MOVES, SOURCE = "Eval host half", "ms", "infer_group_p95_ms", "program_span"


def read(run):
    if run.kind != "infer" or not run.host_half_ms:
        return None
    return sum(run.host_half_ms) / len(run.host_half_ms)
