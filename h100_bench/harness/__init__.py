"""The harness of the port's H100 benchmark (see `h100_bench/run.py`)."""

from __future__ import annotations

import math
import sys
from typing import Dict, List

from . import spec

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "epipolar_transformers_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """One run of `cell`: the result line's keys, in order, with the checks last."""
    from . import compare, infer, train

    driver = {"train": train, "infer": infer}[cell.traffic["kind"]]
    record, checks, attempted, failed, peak = driver.run(cell, seed, seconds, trace, device,
                                                         t_start)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"]).read(record)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": compare.all_within(checks),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"memory_peak_bytes": peak}}
    if trace and record.trace is not None:
        t = record.trace
        result["device"].update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in t.top_ops(10)],
                               "idle_gaps": [[n, s] for n, s in t.idle_gaps(10)]}
    result["checks"] = checks
    return result
