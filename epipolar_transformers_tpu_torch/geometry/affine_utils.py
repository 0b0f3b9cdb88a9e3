"""Normalized (-1, 1) affine parameters, in torch.

Port of epipolar_transformers_tpu/geometry/affine_utils.py (reference
vision/affine_utils.py:5-106): 2x3 affine thetas in grid_sample's normalized
coordinates for crop, scale, offset, mirror and rotate, their composition,
point normalization, and a theta solved from point pairs by least squares.
The builders return float32 tensors, as the JAX ones return float32
arrays; `compose`, `solve_theta` and `apply_theta` keep their inputs'
dtype and device.
"""

from __future__ import annotations

import torch


def _theta(rows, dtype=torch.float32) -> torch.Tensor:
    return torch.stack([torch.stack([torch.as_tensor(v, dtype=dtype) for v in r]) for r in rows])


def identity_theta(dtype=torch.float32) -> torch.Tensor:
    return _theta([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype)


def crop2affine(box_xyxy_norm) -> torch.Tensor:
    """A normalized crop box (x0, y0, x1, y1) in (-1, 1) -> the theta that
    maps the output grid onto the box."""
    x0, y0, x1, y1 = box_xyxy_norm
    return _theta([[(x1 - x0) / 2.0, 0.0, (x1 + x0) / 2.0],
                   [0.0, (y1 - y0) / 2.0, (y1 + y0) / 2.0]])


def scale2affine(sx, sy) -> torch.Tensor:
    return _theta([[sx, 0.0, 0.0], [0.0, sy, 0.0]])


def offset2affine(dx, dy) -> torch.Tensor:
    return _theta([[1.0, 0.0, dx], [0.0, 1.0, dy]])


def mirror2affine(horizontal: bool = True) -> torch.Tensor:
    if horizontal:
        return _theta([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    return _theta([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def rotate2affine(angle_rad) -> torch.Tensor:
    a = torch.as_tensor(angle_rad, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    return _theta([[c, -s, 0.0], [s, c, 0.0]])


def _homogeneous(theta: torch.Tensor) -> torch.Tensor:
    last = torch.tensor([[0.0, 0.0, 1.0]], dtype=theta.dtype, device=theta.device)
    return torch.cat([theta, last], dim=0)


def compose(theta_a: torch.Tensor, theta_b: torch.Tensor) -> torch.Tensor:
    """theta_b applied after theta_a (2x3 each)."""
    return (_homogeneous(theta_b) @ _homogeneous(theta_a))[:2]


def normalize_points(pts, H, W, correct: bool = True):
    """Pixel points -> (-1, 1) (geometry.camera's convention)."""
    from .camera import normalize_pixel

    return normalize_pixel(pts, H, W, correct)


def denormalize_points(pts, H, W, correct: bool = True):
    from .camera import denormalize_pixel

    return denormalize_pixel(pts, H, W, correct)


def _ones_column(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)


def solve_theta(src_pts: torch.Tensor, dst_pts: torch.Tensor) -> torch.Tensor:
    """The least-squares 2x3 affine with dst = theta [src, 1] (reference
    affine_utils' lstsq theta solver)."""
    return torch.linalg.lstsq(_ones_column(src_pts), dst_pts).solution.T


def apply_theta(theta: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return _ones_column(pts) @ theta.T
