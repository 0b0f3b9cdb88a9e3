"""Depth oracle: features warped between views through ground-truth depth.

Port of epipolar_transformers_tpu/models/oracle.py (reference
modeling/layers/oracle.py:6-121), a sanity-check layer: each pixel is
unprojected with its ground-truth depth, moved into the other camera,
projected, and the other view's features are sampled there bilinearly
(`ops/grid_sample.grid_sample_2d`, align_corners=True, zero padding): an
upper bound for any learned correspondence.  Channels-last, batched.
"""

from __future__ import annotations

import torch

from ..ops.grid_sample import grid_sample_2d


def _warp(feat_other, depth, K1, R1, t1, K2, R2, t2, bbox, full_w, full_h):
    """The other view's (H, W, C) features sampled where each pixel of this
    view lands, through its depth (H, W)."""
    H, W = depth.shape
    sx = (bbox[2] - bbox[0]) / W * full_w
    sy = (bbox[3] - bbox[1]) / H * full_h
    xs, ys = torch.meshgrid(torch.arange(W, dtype=depth.dtype, device=depth.device),
                            torch.arange(H, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    x = xs * sx + bbox[0]
    y = ys * sy + bbox[1]
    homo = torch.stack([x, y, torch.ones_like(x)]).reshape(3, -1)
    local3d = homo * depth.reshape(1, -1)
    world = torch.linalg.inv(R1) @ (torch.linalg.inv(K1) @ local3d - t1.reshape(3, 1))
    homo_world = torch.cat([world, torch.ones_like(world[:1])])
    rel = K2 @ (torch.cat([R2, t2.reshape(3, 1)], dim=1) @ homo_world)
    uv = (rel[:2] / rel[2:3]).T.reshape(W, H, 2)
    grid = uv / W * 2.0 - 1.0  # normalized by the image width (reference :86-90)
    return grid_sample_2d(feat_other, grid)


def depth_oracle_warp(feat, depth1, depth2, K1, R1, t1, K2, R2, t2, bbox1, bbox2,
                      full_w=667, full_h=1024):
    """
    Args (batched, channels-last):
        feat: (N, 2, H, W, C) the two views' features.
        depth1/depth2: (N, H, W) ground-truth depths.
        K/R/t of each view: (N, 3, 3) / (N, 3, 3) / (N, 3).
        bbox1/bbox2: (N, 4) crops in full-image coordinates.
    Returns:
        (N, 2, H, W, 2C): each view's features, then the other view's
        features warped into it.  Note the (W, H) grid of the reference, so
        the warped half is transposed when H != W, in both packages.
    """
    out = []
    for n in range(feat.shape[0]):
        into1 = _warp(feat[n, 1], depth1[n], K1[n], R1[n], t1[n], K2[n], R2[n], t2[n], bbox1[n],
                      full_w, full_h)
        into2 = _warp(feat[n, 0], depth2[n], K2[n], R2[n], t2[n], K1[n], R1[n], t1[n], bbox2[n],
                      full_w, full_h)
        out.append(torch.stack([torch.cat([feat[n, 0], into1], -1),
                                torch.cat([feat[n, 1], into2], -1)]))
    return torch.stack(out)
