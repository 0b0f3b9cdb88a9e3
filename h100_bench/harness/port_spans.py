"""The port's own spans and counters over the traced part of a window, as
the `program_span` readers see them.

The port (`epipolar_transformers_tpu_torch/utils/tracing.py`) records its
spans while a `torch.profiler` runs: the window's traced part turns them on
at its first step or group.  The first reader of a run turns them off and
drains them once; the device spans' CUDA events and the attention's tile
counts are resolved then, after the window's own synchronize.  The spans
kept are those inside the traced window.  That first drain also prints one
table on standard error: each span's calls, host ms, self ms, device ms
and host syncs a step (or group), and the traced part's idle device
seconds named by the innermost span, the benchmark's or the port's, that
holds each gap's middle.

A program without that module, or a run without a trace or without the
port's spans, gives None, and so does each reader.
"""

from __future__ import annotations

import heapq
import importlib
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# the span of one train step and of one eval group
STEP_SPAN = {"train": "train_step", "infer": "eval_step"}


@dataclass
class PortSpans:
    """Spans (start_s, end_s, name, parent index or -1, device ms or None)
    on the profiler's clock, and counters {(span index or -1, name): n}."""

    spans: List[Tuple[float, float, str, int, Optional[float]]]
    counters: Dict[Tuple[int, str], int]
    step_span: str

    @property
    def steps(self) -> int:
        return sum(1 for s in self.spans if s[2] == self.step_span)

    def host_ms(self, name: str) -> float:
        """Host milliseconds inside the spans named `name` (inclusive)."""
        return 1e3 * sum(s[1] - s[0] for s in self.spans if s[2] == name)

    def device_ms(self, names: Sequence[str]) -> Optional[float]:
        """The CUDA events' milliseconds of the device spans named in
        `names`; None where none of them has device time."""
        times = [s[4] for s in self.spans if s[2] in names and s[4] is not None]
        return sum(times) if times else None

    def roots(self) -> List[int]:
        """Each span's outermost ancestor (itself at the top)."""
        out: List[int] = []
        for i, s in enumerate(self.spans):
            out.append(out[s[3]] if 0 <= s[3] < i else i)
        return out

    def counted(self, name: str, under: Sequence[str]) -> int:
        """The counter `name` summed over the spans whose outermost ancestor
        is named in `under`."""
        roots = self.roots()
        return sum(n for (i, c), n in self.counters.items()
                   if c == name and i >= 0 and self.spans[roots[i]][2] in under)

    def total(self, name: str) -> int:
        """The counter `name` under any span or none."""
        return sum(n for (_, c), n in self.counters.items() if c == name)


_DRAINED: Dict[int, tuple] = {}  # id(run) -> (run, PortSpans or None)


def attach(run, spans: Optional[PortSpans]) -> None:
    """Give `run` these port spans (what the first drain would give)."""
    _DRAINED[id(run)] = (run, spans)


def of(run) -> Optional[PortSpans]:
    """The port's spans of `run`'s traced part, drained on the first call."""
    if id(run) not in _DRAINED:
        attach(run, _drain(run))
        if _DRAINED[id(run)][1] is not None:
            print_table(run, _DRAINED[id(run)][1])
    return _DRAINED[id(run)][1]


def _drain(run) -> Optional[PortSpans]:
    try:
        tracing = importlib.import_module("epipolar_transformers_tpu_torch.utils.tracing")
    except ImportError:
        return None
    tracing.disable()
    spans, counters = tracing.drain()
    if run.trace is None or not spans:
        return None
    return from_drained(spans, counters, run.trace.start, run.trace.end, STEP_SPAN[run.kind])


def from_drained(spans, counters, start: float, end: float, step_span: str) -> PortSpans:
    """The drained spans that lie inside [start, end] (seconds on the
    profiler's clock), re-indexed, with their counters."""
    keep: Dict[int, int] = {}
    out = []
    for i, s in enumerate(spans):
        t0, t1 = s.start_ns / 1e9, s.end_ns / 1e9
        if start <= t0 and t1 <= end:
            keep[i] = len(out)
            out.append((t0, t1, s.name, keep.get(s.parent, -1), s.device_ms))
    kept = {(keep.get(i, -1), name): n for (i, name), n in counters.items()
            if i < 0 or i in keep}
    return PortSpans(out, kept, step_span)


def idle_gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle gaps inside the trace's window (`Trace.idle_gaps`'
    gaps, unnamed)."""
    gaps: List[Tuple[float, float]] = []
    cur = trace.start
    for t0, t1, _ in trace.device:
        if t0 > cur:
            gaps.append((cur, min(t0, trace.end)))
        cur = max(cur, t1)
        if cur >= trace.end:
            break
    if cur < trace.end:
        gaps.append((cur, trace.end))
    return [(g0, g1) for g0, g1 in gaps if g1 > g0]


def idle_by_innermost_span(gaps: Sequence[Tuple[float, float]],
                           spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost span (the latest to start) that
    holds each gap's middle, "other" outside every span, longest first."""
    order = sorted(spans)
    total: Dict[str, float] = {}
    open_: List[Tuple[float, float, str]] = []  # (-start, end, name)
    nxt = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while nxt < len(order) and order[nxt][0] <= mid:
            heapq.heappush(open_, (-order[nxt][0], order[nxt][1], order[nxt][2]))
            nxt += 1
        while open_ and open_[0][1] < mid:  # ended before this middle, and every later one
            heapq.heappop(open_)
        name = open_[0][2] if open_ else "other"
        total[name] = total.get(name, 0.0) + (g1 - g0)
    return sorted(total.items(), key=lambda kv: -kv[1])


def print_table(run, port: PortSpans) -> None:
    steps = max(port.steps, 1)
    child = [0.0] * len(port.spans)
    for s in port.spans:
        if s[3] >= 0:
            child[s[3]] += s[1] - s[0]
    rows: Dict[str, List[float]] = {}
    for i, s in enumerate(port.spans):
        r = rows.setdefault(s[2], [0, 0.0, 0.0, 0.0, 0])
        r[0] += 1
        r[1] += 1e3 * (s[1] - s[0])
        r[2] += 1e3 * (s[1] - s[0] - child[i])
        r[3] += s[4] or 0.0
    for (i, c), n in port.counters.items():
        if i >= 0 and c == "host_syncs":
            rows[port.spans[i][2]][4] += n
    print(f"port spans, a {port.step_span} ({port.steps} in the traced part): "
          "calls, host ms, self ms, device ms, host syncs", file=sys.stderr)
    for name, r in rows.items():
        print(f"  {name:<30} {r[0] / steps:8.2f} {r[1] / steps:10.3f} {r[2] / steps:10.3f} "
              f"{r[3] / steps:10.3f} {r[4] / steps:8.2f}", file=sys.stderr)
    others = {c: n for (i, c), n in port.counters.items() if i < 0}
    print(f"  counters outside the spans: {others}", file=sys.stderr)
    if run.trace is not None:
        spans = list(run.trace.spans) + [s[:3] for s in port.spans]
        named = idle_by_innermost_span(idle_gaps(run.trace), spans)
        print(f"idle seconds by innermost span: {[[n, s] for n, s in named]}", file=sys.stderr)
