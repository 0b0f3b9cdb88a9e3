"""The share of the traced part's device busy time that lies inside the
hourglass's fusion brackets, in %: each merge point's whole fusion (the
attention, `z` and BN, the residual adds), forward and backward, between
the port's device marks `hourglass_fusion_*` (its `ops/trace_marks.py`),
which a CUDA graph's replay runs with the kernels between them.  The
brackets pair as harness/brackets.py pairs the pooled attention's (a copy
of its `program_marks`, `_is` and `brackets` with these marks, until
`brackets.py` takes the marks as an argument): from the end of a begin
mark to the start of the next end mark of its phase, a bracket cut by the
traced part's edges left out.  None for a program
without these marks; a traced part of a program that has them but left no
whole bracket of each phase there is an error, not a reading."""

import importlib
from typing import Dict, List, Tuple

from h100_bench.harness import brackets

LAYER, UNIT, MOVES, SOURCE = "Hourglass fusion", "%", "train_samples_per_s", "device_trace"

MARKS = {"forward": ("hourglass_fusion_forward_begin", "hourglass_fusion_forward_end"),
         "backward": ("hourglass_fusion_backward_begin", "hourglass_fusion_backward_end")}


def program_marks() -> bool:
    """Whether the program launches the marks that `MARKS` names."""
    try:
        module = importlib.import_module("epipolar_transformers_tpu_torch.ops.trace_marks")
    except ImportError:
        return False
    names = set(getattr(module, "MARKS", ()))
    return all(m in names for pair in MARKS.values() for m in pair)


def _is(name: str, mark: str) -> bool:
    return name == mark or name.startswith(mark + "(")


def fusion_brackets(trace) -> Dict[str, List[Tuple[float, float]]]:
    """{phase: [(start_s, end_s), ...]} of the whole brackets in the traced part."""
    out: Dict[str, List[Tuple[float, float]]] = {phase: [] for phase in MARKS}
    opened = {phase: None for phase in MARKS}
    for t0, t1, name in trace.kernels:
        if not trace.start <= t0 < trace.end:
            continue
        for phase, (begin, end) in MARKS.items():
            if _is(name, begin):
                opened[phase] = t1
            elif _is(name, end) and opened[phase] is not None:
                out[phase].append((opened[phase], t0))
                opened[phase] = None
    return out


def read(run):
    if run.kind != "train" or run.trace is None or not program_marks():
        return None
    found = fusion_brackets(run.trace)
    if not found["forward"] or not found["backward"]:
        raise RuntimeError(f"no whole bracket of each phase of {MARKS} in the traced part: "
                           "renamed, or taken off the path?")
    inside = brackets.busy_inside(run.trace, sorted(found["forward"] + found["backward"]))
    return 100.0 * inside / run.trace.busy_s()
