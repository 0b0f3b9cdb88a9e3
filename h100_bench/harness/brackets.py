"""The pooled attention's intervals in a device trace, between the port's
device marks: empty named kernels that the program launches before and
after the attention's forward and its backward (the port's
`ops/trace_marks.py`), which a CUDA graph's replay runs as it runs the
kernels between them.

A bracket is the interval from the end of a begin mark to the start of the
next end mark of its phase; one cut by the traced part's edges is left out.
`program_marks()` says whether the program under test has the marks at all
(a program without them gives no reading, where one with them that left no
bracket in the traced part is an error of its reader)."""

from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, Tuple

MARKS = {"forward": ("epipolar_pooled_forward_begin", "epipolar_pooled_forward_end"),
         "backward": ("epipolar_pooled_backward_begin", "epipolar_pooled_backward_end")}


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


def brackets(trace) -> Dict[str, List[Tuple[float, float]]]:
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


def busy_inside(trace, intervals: List[Tuple[float, float]]) -> float:
    """Seconds of the union of the device's work (kernels, copies, fills)
    inside `intervals`."""
    merged: List[List[float]] = []  # the union, disjoint and in time order
    for t0, t1, _ in trace.device:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    ends = [m[1] for m in merged]
    busy = 0.0
    for a, b in intervals:
        for m0, m1 in merged[bisect.bisect_right(ends, a):]:
            if m0 >= b:
                break
            busy += min(m1, b) - max(m0, a)
    return busy
