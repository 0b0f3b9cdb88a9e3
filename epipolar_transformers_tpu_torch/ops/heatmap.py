"""Gaussian heatmap grid (numpy).

Port of `make_heatmap_grid` from epipolar_transformers_tpu/ops/heatmap.py
(reference data/transforms/keypoints2d.py:3-80): the grid lives in
full-resolution image coordinates, idx*downsample + downsample/2 - 0.5,
divided by the effective sigma sigma*sqrt(2).
"""

from __future__ import annotations

import numpy as np


def make_heatmap_grid(heatmap_size: tuple[int, int], downsample: int, sigma: float) -> np.ndarray:
    """Precompute the (2, H, W) grid of (y, x) image coords / sigma'."""
    H, W = heatmap_size
    sig = sigma * 2 ** 0.5
    grid = np.mgrid[0:H, 0:W].astype(np.float32)  # grid[0]=y rows, grid[1]=x cols
    offset = downsample / 2.0 - 0.5
    return (grid * downsample + offset) / sig
