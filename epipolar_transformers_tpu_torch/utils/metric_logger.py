"""Windowed meters (reference utils/metric_logger.py:7-83).

The port's own copy of `SmoothedValue` and `MetricLogger` from
epipolar_transformers_tpu/utils/metric_logger.py; the eval engine averages
its per-group metrics with them.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """Track a series of values and provide access to smoothed values over a
    window (20) plus the global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})" for name, m in self.meters.items()
        )

    def get_all_avg(self):
        return {name: m.global_avg for name, m in self.meters.items()}
