"""Spans and counters inside the port, on the profiler's clock.

A span records, while tracing is on, its name, its start and end on
`time.time_ns` (the clock of `torch.profiler`'s timestamps), the span it
opened inside (its parent), its thread and the id of the current step or
eval group.  `span(name, device=True)` also records a pair of CUDA events
on the current stream, resolved only by `drain()`, after the caller's own
synchronize; `launching()` moves the start event to just before the
launches.  `count(name, n)` adds to a counter kept against the innermost
open span.  While tracing is off, `span` and `step` read a flag and return
one shared no-op context: no clock is read, nothing is allocated.

Spans nest in time: the innermost open span is the parent of the next one,
on whichever thread it opens, so the CUDA backward's span on autograd's
device thread is the child of the `train.backward` that waits for it.

    tracing.enable()          # a new recording
    ...                       # train steps, eval groups
    tracing.disable()
    spans, counters = tracing.drain()

`step(name)` opens the span of one train step or eval group and gives it a
new id.  A running `torch.profiler` turns tracing on at the next step and
off at the first step after the profiler stops, so a profiled window gets
the port's spans (the benchmark's traced part); `drain()` takes them.
`enable(annotate=True)` (`main.py --trace`) also opens a
`torch.profiler.record_function` range of the span's name in every span, so
the Chrome trace carries the same names.

Host syncs: on a CUDA machine tracing sets `torch.cuda.set_sync_debug_mode`
to "warn" and counts each of its warnings as `host_syncs` against the
innermost open span, without printing it; `disable()` restores both.  A
sync on autograd's thread reaches Python when `backward()` returns, inside
the span around it.

Device counts: a module registers a dict of per-device int64 tensors
with a name for each element (`register_device_counts`: the attention's
tiles on each path, the pooled attention's samples); enable() zeroes each
tensor in place (a CUDA graph that adds into one keeps adding into it) and
the first drain() after it sums them (that syncs), as counters under no
span (index -1), and leaves them for their other readers.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

SYNC_WARNING = "called a synchronizing CUDA operation"


class Span(NamedTuple):
    """A drained span; `parent` is an index into the drained list, -1 for
    none; `device_ms` the CUDA events' milliseconds of a device span."""

    name: str
    parent: int
    thread: int
    step: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_OFF = _Off()
_on = False  # the one flag the off path reads
_annotate = False
_follows_profiler = False  # turned on by a running profiler, not by enable()
_lock = threading.Lock()
_records: List[list] = []  # [name, parent, thread, step, start, end, events]
_counters: Dict[Tuple[int, str], int] = {}
_innermost = -1  # index of the innermost open span
_step = -1
_generation = 0  # of the buffers, new at each drain
_device_counts: List[Tuple[dict, Tuple[str, ...]]] = []
_counts_due = False  # the device counts not yet summed since enable()
_restore: Optional[tuple] = None  # the sync debug mode and warnings to put back


class _Span:
    __slots__ = ("name", "device", "record", "events", "annotation", "generation")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        global _innermost
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.annotation = None
        if _annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        with _lock:
            self.record = [self.name, _innermost, threading.get_ident(), _step, 0, 0,
                           self.events]
            self.generation = _generation
            _innermost = len(_records)
            _records.append(self.record)
        if self.events is not None:
            self.events[0].record()
        self.record[4] = time.time_ns()

    def __exit__(self, *exc):
        global _innermost
        self.record[5] = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            if self.generation == _generation:  # not drained while open
                _innermost = self.record[1]
        return False


def span(name: str, device: bool = False):
    """A context that records a span of `name` while tracing is on; with
    `device`, CUDA events too."""
    if not _on:
        return _OFF
    return _Span(name, device)


def step(name: str):
    """The span of one train step or eval group, with a new step id.
    Follows a running `torch.profiler` (module docstring)."""
    global _step, _follows_profiler
    if not _on:
        if not _profiler._is_profiler_enabled:
            return _OFF
        enable()
        _follows_profiler = True
    elif _follows_profiler and not _profiler._is_profiler_enabled:
        disable()
        return _OFF
    _step += 1
    return _Span(name, False)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span."""
    if not _on:
        return
    with _lock:
        key = (_innermost, name)
        _counters[key] = _counters.get(key, 0) + n


def launching() -> None:
    """Re-record the innermost open device span's start event, just before
    its launches: its device time then leaves out the host work before
    them, which an idle device would otherwise count."""
    if not _on:
        return
    with _lock:
        events = _records[_innermost][6] if _innermost >= 0 else None
    if events is not None:
        events[0].record()


def register_device_counts(counts: dict, names: Tuple[str, ...]) -> None:
    """Zero `counts` ({device: int64 tensor of len(names) elements}) when
    tracing turns on, and sum it into the counters `names` at the first
    drain after that."""
    _device_counts.append((counts, names))


def enabled() -> bool:
    """Whether spans are being recorded."""
    return _on


def _count_sync(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        count("host_syncs")
    else:
        _restore[2](message, category, filename, lineno, file, line)


def enable(annotate: bool = False) -> None:
    """Start a new recording: empty the buffers, zero the registered device
    counts, count host syncs on a CUDA machine, and turn the spans on."""
    global _on, _annotate, _follows_profiler, _step, _restore, _counts_due
    disable()
    _take()
    for counts, _ in _device_counts:
        for pair in counts.values():
            pair.zero_()
    _counts_due = True
    if torch.cuda.is_available():
        caught = warnings.catch_warnings()
        caught.__enter__()
        _restore = (torch.cuda.get_sync_debug_mode(), caught, warnings.showwarning)
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        warnings.showwarning = _count_sync
        torch.cuda.set_sync_debug_mode("warn")
    _step = -1
    _annotate, _follows_profiler, _on = annotate, False, True


def disable() -> None:
    """Stop recording (what was recorded stays for `drain`), and restore the
    sync debug mode and the warning settings."""
    global _on, _annotate, _follows_profiler, _restore
    if not _on:
        return
    _on = _annotate = _follows_profiler = False
    if _restore is not None:
        mode, caught, _ = _restore
        torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)
        _restore = None


def _take() -> Tuple[List[list], Dict[Tuple[int, str], int]]:
    global _records, _counters, _generation, _innermost
    with _lock:
        records, counters = _records, _counters
        _records, _counters, _innermost = [], {}, -1
        _generation += 1
    return records, counters


def drain() -> Tuple[List[Span], Dict[Tuple[int, str], int]]:
    """(spans, counters) recorded since `enable()`, and empty the buffers.
    Counters are keyed by (index of their span in `spans`, or -1, name).
    The device spans' events are waited for here, and the first drain after
    `enable()` sums the registered device counts (a sync) under -1.  A span
    still open is left out, and its children and counters hang under -1."""
    global _counts_due
    records, counters = _take()
    keep = {i: n for n, i in enumerate(i for i, r in enumerate(records) if r[5])}
    spans = []
    for name, parent, thread, step_id, start, end, events in records:
        if not end:
            continue
        ms = None
        if events is not None:
            events[1].synchronize()
            ms = events[0].elapsed_time(events[1])
        spans.append(Span(name, keep.get(parent, -1), thread, step_id, start, end, ms))
    out: Dict[Tuple[int, str], int] = {}
    for (index, name), n in counters.items():
        key = (keep.get(index, -1), name)
        out[key] = out.get(key, 0) + n
    for counts, names in _device_counts if _counts_due else ():
        total = sum(t.to("cpu") for t in counts.values()).tolist() if counts else [0]
        if any(total):  # no launch since enable(): no counters
            for name, n in zip(names, total):
                out[(-1, name)] = int(n)
    _counts_due = False
    return spans, out


def summary(spans: List[Span], counters: Dict[Tuple[int, str], int]) -> Dict[str, Dict]:
    """Each span name's calls, host ms (inclusive), self ms (less its
    children's host time) and device ms, and the counters under it."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    rows: Dict[str, Dict] = {}
    for i, s in enumerate(spans):
        row = rows.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                       "device_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += (s.end_ns - s.start_ns) / 1e6
        row["self_ms"] += (s.end_ns - s.start_ns - child_ns[i]) / 1e6
        row["device_ms"] += s.device_ms or 0.0
    for (index, name), n in counters.items():
        if index >= 0:
            row = rows[spans[index].name]
            row[name] = row.get(name, 0) + n
    return rows
