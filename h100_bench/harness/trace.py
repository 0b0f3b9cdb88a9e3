"""What a `torch.profiler` run over the measured window holds: the device's
work (kernels, copies, fills), the benchmark's own host spans, and what
the readers of the per-layer metrics take from them.

The busy time is the union of the device's work inside the window (the
arithmetic of the port's `utils/profiling.py:trace_summary`, copied), the
kernel table and the idle gaps are taken over the window alone, and each
gap is named by the benchmark's span the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Trace:
    """Device intervals (start_s, end_s, name) in time order, host spans
    (start_s, end_s, name), and the window [start_s, end_s]."""

    device: List[Tuple[float, float, str]]
    spans: List[Tuple[float, float, str]]
    start: float
    end: float
    kernels: List[Tuple[float, float, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """The union of the device's work inside the window."""
        busy, cur = 0.0, self.start
        for t0, t1, _ in self.device:
            t0, t1 = max(t0, cur), min(t1, self.end)
            if t1 > t0:
                busy += t1 - t0
                cur = t1
        return busy

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time in the window, summed by name."""
        total: Dict[str, float] = {}
        for t0, t1, name in self.device:
            total[name] = total.get(name, 0.0) + max(0.0, min(t1, self.end) - max(t0, self.start))
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The device's idle gaps in the window, summed by the benchmark span
        the host was in at each gap's middle ("other" outside them), longest
        first."""
        gaps: List[Tuple[float, float]] = []
        cur = self.start
        for t0, t1, _ in self.device:
            if t0 > cur:
                gaps.append((cur, min(t0, self.end)))
            cur = max(cur, t1)
            if cur >= self.end:
                break
        if cur < self.end:
            gaps.append((cur, self.end))
        spans = sorted(self.spans)
        starts = [s[0] for s in spans]
        total: Dict[str, float] = {}
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            i = bisect.bisect_right(starts, mid) - 1
            name = spans[i][2] if i >= 0 and mid <= spans[i][1] else "other"
            total[name] = total.get(name, 0.0) + (g1 - g0)
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def kernel_count(self) -> int:
        """Kernels that started inside the window."""
        return sum(1 for t0, _, _ in self.kernels if self.start <= t0 < self.end)

    def phase_times(self, forward: Sequence[str], backward: Sequence[str],
                    shared: Sequence[str] = ()) -> Dict[str, float]:
        """Device seconds of the kernels that `forward` and `backward` name
        (a function name, followed in the trace by its template or its
        arguments), inside the window.  A kernel of `shared` (run by both)
        counts for the phase of the next named kernel after it."""

        def named_in(name, words):
            return any(w + "<" in name or w + "(" in name for w in words)

        named = []
        for t0, t1, name in self.kernels:
            if not self.start <= t0 < self.end:
                continue
            if named_in(name, shared):
                named.append((t0, t1, None))
            elif named_in(name, forward):
                named.append((t0, t1, "forward"))
            elif named_in(name, backward):
                named.append((t0, t1, "backward"))
        out = {"forward": 0.0, "backward": 0.0}
        owner: Optional[str] = None
        for t0, t1, phase in reversed(named):
            if phase is not None:
                owner = phase
            if owner is not None:
                out[owner] += t1 - t0
        return out


def from_profiler(prof, start: float, end: float,
                  spans: Sequence[Tuple[float, float, str]]) -> Trace:
    """A Trace of a finished `torch.profiler.profile` of the device's work
    over the window [start, end], with the benchmark's own host spans, all
    in seconds on the profiler's clock (`time.time_ns`)."""
    device, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        name = e.name()
        t = (e.start_ns() / 1e9, e.end_ns() / 1e9, name)
        device.append(t)
        if not name.startswith(("Memcpy", "Memset")):
            kernels.append(t)
    device.sort()
    kernels.sort()
    return Trace(device, list(spans), start, end, kernels)
