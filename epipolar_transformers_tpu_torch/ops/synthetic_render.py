"""Per-joint splat colours of the synthetic rig (numpy).

Port of `joint_colors` from epipolar_transformers_tpu/ops/
synthetic_render.py.  The on-device renderer of that module waits for
ROADMAP A12.
"""

from __future__ import annotations

import numpy as np


def _hsv_to_rgb(h: float, s: float, v: float):
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def joint_colors(num_joints: int) -> np.ndarray:
    """Maximally distinct per-joint splat colors (evenly spaced hues)."""
    hues = np.linspace(0.0, 1.0, num_joints, endpoint=False)
    return np.stack(
        [_hsv_to_rgb(h, 0.9, 1.0) for h in hues]
    ).astype(np.float32)
