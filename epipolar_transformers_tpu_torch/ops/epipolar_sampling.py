"""Epipolar-line sample locations (PyTorch, batched over N).

Port of epipolar_transformers_tpu/ops/epipolar_sampling.py (reference
`Epipolar.grid2sample_locs`, modeling/layers/epipolar.py:323-418): for every
reference-view feature pixel, compute its epipolar line in the source view,
clip the line to the image rectangle with the reference's stability rules,
and emit K evenly spaced samples between the first two valid
intersections, normalized to (-1, 1).  Lines that miss the rectangle get
far-out-of-range locations, which sample to exact zeros and are masked by
the attention.  Computed in float32 (in float64 for a float64 `grid`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import camera_center_h, coord2pix, normalize_pixel, pinv34, pix2coord

EPSILON = 0.001  # reference epipolar.py:20


class EpipolarGeometry(NamedTuple):
    """Static geometry of the sampling problem."""

    feat_h: int
    feat_w: int
    sample_size: int
    downsample: int
    resize: float  # IMAGE_RESIZE * PREDICT_RESIZE
    correct_normalize: bool

    @property
    def xmin(self) -> float:
        return pix2coord(0.0, self.downsample) * self.resize

    @property
    def xmax(self) -> float:
        return pix2coord(self.feat_w - 1.0, self.downsample) * self.resize

    @property
    def ymin(self) -> float:
        return pix2coord(0.0, self.downsample) * self.resize

    @property
    def ymax(self) -> float:
        return pix2coord(self.feat_h - 1.0, self.downsample) * self.resize

    def grid(self, dtype=np.float32) -> np.ndarray:
        """(3, H*W) homogeneous full-res image coords of every feature pixel."""
        y = pix2coord(np.arange(self.feat_h, dtype=np.float64), self.downsample) * self.resize
        x = pix2coord(np.arange(self.feat_w, dtype=np.float64), self.downsample) * self.resize
        gy, gx = np.meshgrid(y, x, indexing="ij")
        return np.stack([gx, gy, np.ones_like(gx)]).reshape(3, -1).astype(dtype)


def _stable_div(num, den):
    # reference epipolar.py:369-373: sign(den) * max(|den|, eps)
    sign = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    return num / (sign * torch.clamp(den.abs(), min=EPSILON))


def epipolar_sample_locs(P1: torch.Tensor, P2: torch.Tensor, geom: EpipolarGeometry,
                         grid: torch.Tensor | None = None) -> torch.Tensor:
    """Sample locations along each pixel's epipolar line in the other view.

    Args:
        P1: (N, 3, 4) reference-view projections (full-res image coords).
        P2: (N, 3, 4) source-view projections.
        geom: static geometry.
        grid: optional (N, 3, H*W) homogeneous full-res points to take the
            lines of, in place of the feature pixels (`geom.grid()`); the
            locations are differentiable in it (the reprojection loss).
    Returns:
        (N, K, H, W, 2) float32 normalized (x, y) in (-1, 1); float64 for
        a float64 grid.
    """
    H, W, K = geom.feat_h, geom.feat_w, geom.sample_size
    if grid is None:
        grid = torch.as_tensor(geom.grid(), device=P1.device)  # (3, HW)
    dtype = torch.promote_types(grid.dtype, torch.float32)
    P1 = P1.to(dtype)
    P2 = P2.to(dtype)
    grid = grid.to(dtype)
    N = P1.shape[0]

    # epipolar line l2 = e2 x (P2 P1^+ x1)   (reference epipolar.py:334-352)
    X = pinv34(P1) @ grid  # (N, 4, HW)
    x2 = P2 @ X  # (N, 3, HW)
    x2 = x2 / x2[:, 2:3, :]
    e2 = (P2 @ camera_center_h(P1)[..., None])[..., 0]  # (N, 3)
    e2 = e2 / e2[:, 2:3]
    l2 = torch.linalg.cross(e2[:, :, None].expand_as(x2), x2, dim=1)  # (N, 3, HW)
    a, b, c = l2[:, 0], l2[:, 1], l2[:, 2]  # (N, HW)

    xmin, xmax, ymin, ymax = geom.xmin, geom.xmax, geom.ymin, geom.ymax
    eps = EPSILON
    by1 = _stable_div(-(xmin * a + c), b)  # y at x = xmin
    by2 = _stable_div(-(xmax * a + c), b)  # y at x = xmax
    bx0 = _stable_div(-(ymin * b + c), a)  # x at y = ymin
    bx3 = _stable_div(-(ymax * b + c), a)  # x at y = ymax

    # 4 candidate intersections with half-open corner conventions
    # (reference epipolar.py:374-393)
    cand = torch.stack([
        torch.stack([bx0, torch.full_like(bx0, ymin)], -1),
        torch.stack([torch.full_like(by1, xmin), by1], -1),
        torch.stack([torch.full_like(by2, xmax), by2], -1),
        torch.stack([bx3, torch.full_like(bx3, ymax)], -1),
    ], dim=2)  # (N, HW, 4, 2)
    mask = torch.stack([
        (bx0 >= xmin + eps) & (bx0 < xmax - eps),
        (by1 > ymin + eps) & (by1 <= ymax - eps),
        (by2 >= ymin + eps) & (by2 < ymax - eps),
        (bx3 > xmin + eps) & (bx3 <= xmax - eps),
    ], dim=-1)  # (N, HW, 4)
    has_line = mask.sum(-1) >= 2

    # the first two valid intersections in candidate order (stable sort puts
    # the valid ones first, in their original order)
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)[..., :2]
    picked = torch.gather(cand, 2, order[..., None].expand(N, H * W, 2, 2))
    outrange = torch.tensor([xmin - 10000.0, ymin - 10000.0], dtype=picked.dtype,
                            device=picked.device)
    picked = torch.where(has_line[..., None, None], picked, outrange)

    start = picked[:, :, 0]  # (N, HW, 2)
    vec = picked[:, :, 1] - start
    steps = torch.as_tensor(np.linspace(0.0, 1.0, K, dtype=np.float32), device=P1.device)
    locs = start[:, None] + vec[:, None] * steps[None, :, None, None]  # (N, K, HW, 2)

    # back to feature-pixel space, then (-1, 1)   (epipolar.py:410-414)
    locs = coord2pix(locs / geom.resize, geom.downsample)
    locs = normalize_pixel(locs, H, W, correct=geom.correct_normalize)
    return locs.reshape(N, K, H, W, 2)
