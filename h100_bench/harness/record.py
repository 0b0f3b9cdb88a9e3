"""What one run measured, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .trace import Trace


@dataclass
class RunRecord:
    kind: str  # "train" or "infer"
    setup_s: float
    window_s: float  # host clock, first call to the last result
    steps: int  # train steps or view groups completed in the window
    items_per_step: int  # train items a step, or views a group
    peak_window_bytes: int  # max_memory_allocated over the window
    forward_flops_per_item: float  # the reference's count; one item = two views
    peak_flops: float  # of the configuration's compute dtype
    latencies_s: List[float] = field(default_factory=list)  # per group
    eval_forward_ms: List[float] = field(default_factory=list)  # CUDA events per group
    host_half_ms: List[float] = field(default_factory=list)  # host clock per group
    trace: Optional[Trace] = None  # of the window's last seconds, in a traced run
    traced_steps: int = 0  # the calls in the traced part
    untraced_steps: int = 0  # the calls before the traced part (all, untraced)
    untraced_s: float = 0.0  # their host seconds from the window's start
    # the least seconds of the attention calls the traced window made
    attention_bound_s: Dict[str, float] = field(default_factory=dict)
    cards: int = 1  # that the step runs on, one rank each
