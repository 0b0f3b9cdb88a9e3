"""The measured window: host-clock timing of every call in it, and, in a
traced run, a `torch.profiler` trace of its last `TRACE_SECONDS` (a trace
of the whole window would hold millions of events).

The profiler records the device's work alone (CUPTI: kernels, copies,
fills), with no host activity: recording every host operation halved the
train loop's pace on the card.  The window's bounds and the benchmark's
own spans around its calls are taken on `time.time_ns`, the clock of the
profiler's timestamps."""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from . import trace as tracemod

TRACE_SECONDS = 5.0


def _activities(cuda: bool):
    return [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that the device tracer's start-up
    (seconds) falls in set-up and not in the traced part of the window."""
    with profile(activities=_activities(torch.device(device).type == "cuda")):
        torch.ones(1, device=device).add_(1)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


class Window:
    """Call `tick()` after each call of the timed path; it says when
    `seconds` have passed.  `close()` waits for the device and ends the
    window (and the trace)."""

    def __init__(self, seconds: float, trace: bool, device):
        self.seconds, self.trace_on = seconds, trace
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.prof: Optional[profile] = None
        self.spans: List[Tuple[float, float, str]] = []  # in the traced part
        self.traced_at = 0.0  # time.time_ns of the traced part's start, in seconds
        self.traced = False
        self.traced_from = 0  # index of the first call in the traced part
        self.marks: List[float] = []
        self.t0 = time.perf_counter()
        if trace and seconds <= TRACE_SECONDS:
            self._start_trace()

    def _start_trace(self):
        self.prof = profile(activities=_activities(self.cuda))
        self.prof.start()
        self.traced_at = time.time_ns() / 1e9
        self.traced, self.traced_from = True, len(self.marks)

    @contextmanager
    def span(self, name: str):
        """A span of the benchmark's own around a call into the program,
        kept in the traced part."""
        if self.prof is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0 / 1e9, time.time_ns() / 1e9, name))

    def tick(self) -> bool:
        now = time.perf_counter()
        self.marks.append(now)
        if self.trace_on and self.prof is None and now - self.t0 >= self.seconds - TRACE_SECONDS:
            self._start_trace()
        return now - self.t0 >= self.seconds

    @property
    def calls(self) -> int:
        return len(self.marks)

    def untraced(self):
        """(calls, host seconds) of the window before its traced part: the
        pace that the profiler does not slow."""
        n = self.traced_from if self.traced else self.calls
        return n, (self.marks[n - 1] - self.t0) if n else 0.0

    def close(self):
        """(window seconds, Trace or None)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        traced = None
        if self.prof is not None:
            end = time.time_ns() / 1e9
            self.prof.stop()
            traced = tracemod.from_profiler(self.prof, self.traced_at, end, self.spans)
            self.prof = None
        counts = [0] * (int(self.marks[-1] - self.t0) + 1 if self.marks else 0)
        for m in self.marks:
            counts[int(m - self.t0)] += 1
        print(f"window pace, calls a second: {counts}", file=sys.stderr)
        if traced is not None and 0 < self.traced_from < self.calls:
            n, untraced_s = self.untraced()
            traced_pace = (self.calls - n) / (self.marks[-1] - self.marks[n - 1])
            print(f"traced part: {traced_pace:.3f} calls a second against "
                  f"{n / untraced_s:.3f} before it", file=sys.stderr)
        return window_s, traced
