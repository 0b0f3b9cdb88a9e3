"""Camera geometry primitives (PyTorch, batched).

Port of epipolar_transformers_tpu/geometry/camera.py (reference
vision/multiview.py:8-192).  Every function is shape-polymorphic over
leading batch dimensions.

Coordinate conventions (load-bearing for parity):
  * `pix2coord(x, d) = x*d + d/2 - 0.5` maps a feature-map pixel index to
    the image coordinate at feature stride `d`;
  * `normalize_pixel` maps pixel indices to (-1, 1).  The "correct" variant
    is align_corners=True: x_norm = 2x/(W-1) - 1; the legacy variant is
    x_norm = 2(x+0.5)/W - 1.
"""

from __future__ import annotations

import numpy as np
import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) 3x3 inverse, batched over leading dims."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def pinv34(P: torch.Tensor) -> torch.Tensor:
    """Right pseudo-inverse P^T (P P^T)^-1 of a full-row-rank (..., 3, 4)
    projection, with rows and columns equilibrated first (projections are
    badly scaled and the normal equations square the condition number)."""
    rn = torch.linalg.vector_norm(P, dim=-1, keepdim=True)  # (..., 3, 1)
    Pr = P / rn
    cn = torch.linalg.vector_norm(Pr, dim=-2, keepdim=True)  # (..., 1, 4)
    Pe = Pr / cn
    PPt = Pe @ Pe.transpose(-1, -2)
    pinv_e = Pe.transpose(-1, -2) @ inv3x3(PPt)  # (..., 4, 3)
    return pinv_e / cn.transpose(-1, -2) / rn.transpose(-1, -2)


def camera_center(KRT: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) projections -> (..., 3) centers C = -A^-1 b."""
    A = KRT[..., :, :3]
    b = KRT[..., :, 3]
    return -(inv3x3(A) @ b[..., None])[..., 0]


def camera_center_h(KRT: torch.Tensor) -> torch.Tensor:
    """Homogeneous camera center (..., 4) with a trailing 1."""
    c = camera_center(KRT)
    return torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)


def normalize_pixel(pts: torch.Tensor, H: int, W: int, correct: bool = True) -> torch.Tensor:
    """Pixel indices -> (-1, 1); pts[..., 0] is x (width), pts[..., 1] is y."""
    x, y = pts[..., 0], pts[..., 1]
    if correct:
        x = -1.0 + 2.0 * x / (W - 1)
        y = -1.0 + 2.0 * y / (H - 1)
    else:
        x = -1.0 + 2.0 * (x + 0.5) / W
        y = -1.0 + 2.0 * (y + 0.5) / H
    return torch.stack([x, y], dim=-1)


def denormalize_pixel(pts: torch.Tensor, H: int, W: int, correct: bool = True) -> torch.Tensor:
    """(-1, 1) -> pixel indices; the inverse of `normalize_pixel`."""
    x, y = pts[..., 0], pts[..., 1]
    if correct:
        x = (x + 1.0) * (W - 1) / 2.0
        y = (y + 1.0) * (H - 1) / 2.0
    else:
        x = (x + 1.0) * W / 2.0 - 0.5
        y = (y + 1.0) * H / 2.0 - 0.5
    return torch.stack([x, y], dim=-1)


def pix2coord(x, downsample):
    """Feature-pixel index -> full-resolution image coordinate."""
    return x * downsample + downsample / 2.0 - 0.5


def coord2pix(y, downsample):
    """Full-resolution image coordinate -> feature-pixel index."""
    return (y + 0.5 - downsample / 2.0) / downsample


def crossmat(vec: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]_x, batched over leading dims."""
    zeros = torch.zeros_like(vec[..., 0])
    rows = [
        torch.stack([zeros, -vec[..., 2], vec[..., 1]], dim=-1),
        torch.stack([vec[..., 2], zeros, -vec[..., 0]], dim=-1),
        torch.stack([-vec[..., 1], vec[..., 0], zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def fundamental_matrix(P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """F = [e2]_x P2 P1^+ of two (..., 3, 4) projections, x2^T F x1 = 0
    (reference vision/multiview.py:85-147)."""
    e2 = (P2 @ camera_center_h(P1)[..., None])[..., 0]
    return crossmat(e2) @ (P2 @ pinv34(P1))


def neighbor_cameras(krt_by_cam: dict) -> dict:
    """Rank the other cameras by distance between centers (numpy, host).

    Returns {cam_id: (other cam_ids sorted by distance, their distances)}.
    """
    cams = list(krt_by_cam.keys())
    centers = {}
    for k, krt in krt_by_cam.items():
        krt = np.asarray(krt)
        centers[k] = -np.linalg.inv(krt[:, :3]) @ krt[:, 3]
    rank = {}
    for k0, c0 in centers.items():
        dist = {k1: float(np.linalg.norm(c0 - c1)) for k1, c1 in centers.items()}
        order = sorted(cams, key=lambda c: dist[c])
        sorted_dist = np.array(sorted(dist.values()))
        if order[0] != k0:
            raise ValueError(f"camera {k0} shares its center with camera {order[0]}")
        rank[k0] = (order[1:], sorted_dist[1:])
    return rank
