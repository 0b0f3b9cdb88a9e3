"""Reprojection consistency of the epipolar attention, and its loss.

Port of epipolar_transformers_tpu/ops/epipolar_reproject.py (reference
`Epipolar.reproject`, modeling/layers/epipolar.py:420-464), batched over N:
take the attention's expected match in the other view, shoot its epipolar
line back into the reference view, run the same soft attention along it
(the plain path, ops/epipolar_attention.py), and penalize the expected
back-projected position's distance from the pixel it started at.  The
gradient reaches the attention weights through the expected match and
through the back lines' sample locations, as in the JAX package.  The
loss's mask count is taken over the global batch under a process group
(`parallel.global_ratio`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import parallel
from ..geometry.camera import denormalize_pixel, pix2coord
from .epipolar_attention import AttentionParams, epipolar_attention
from .epipolar_sampling import EpipolarGeometry, epipolar_sample_locs
from .grid_sample import grid_sample_nhwc


def expected_match_locs(sample_locs: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Attention-weighted expected sample position (epipolar.py:433-434):
    sample_locs (N, K, H, W, 2) normalized, depth (N, K, H, W) weights ->
    (N, H, W, 2) normalized."""
    dtype = torch.promote_types(sample_locs.dtype, depth.dtype)
    return torch.einsum("nkhwc,nkhw->nhwc", sample_locs.to(dtype), depth.to(dtype))


def reproject_consistency(feat1, feat2, sample_locs, depth, P1, P2,
                          geom: EpipolarGeometry, params: AttentionParams):
    """feat1, feat2 (N, H, W, C); sample_locs (N, K, H, W, 2); depth
    (N, K, H, W); P1, P2 (N, 3, 4) -> (reprojected locations (N, H, W, 2)
    normalized, mask (N, H, W, 1) of those inside the image)."""
    N, H, W, _ = feat1.shape
    expected = expected_match_locs(sample_locs, depth)
    matched = grid_sample_nhwc(feat2, expected)  # (N, H, W, C)

    # normalized -> full-res image coords (epipolar.py:438-440)
    pix = denormalize_pixel(expected, H, W, correct=geom.correct_normalize)
    coords = pix2coord(pix, geom.downsample) * geom.resize
    grid = torch.cat([coords.reshape(N, H * W, 2),
                      torch.ones(N, H * W, 1, dtype=coords.dtype, device=coords.device)], -1)
    # the matched points' epipolar lines back in view 1 (P order swapped)
    back_locs = epipolar_sample_locs(P2, P1, geom, grid.transpose(1, 2))

    _, _, weights = epipolar_attention(matched, feat1, feat1, back_locs, params)
    reproj = torch.einsum("nkhwc,nkhw->nhwc", back_locs[:, :weights.shape[1]],
                          weights.to(back_locs.dtype))
    mask = ((reproj.amin(-1) > -1) & (reproj.amax(-1) < 1))[..., None]
    return reproj, mask


def gt_grid(geom: EpipolarGeometry) -> np.ndarray:
    """The normalized identity pixel grid (H, W, 2) the reprojection should
    match (epipolar.py:26-28)."""
    H, W = geom.feat_h, geom.feat_w
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    if geom.correct_normalize:
        gx = -1.0 + 2.0 * xs / (W - 1)
        gy = -1.0 + 2.0 * ys / (H - 1)
    else:
        gx = -1.0 + 2.0 * (xs + 0.5) / W
        gy = -1.0 + 2.0 * (ys + 0.5) / H
    return np.stack([gx, gy], axis=-1).astype(np.float32)


@functools.cache
def gt_grid_on(geom: EpipolarGeometry, device: torch.device) -> torch.Tensor:
    """`gt_grid(geom)` on `device`, uploaded once (an upload waits for the
    host and cannot be held in a CUDA graph); a normal tensor even under
    inference_mode."""
    with torch.inference_mode(False):
        return torch.as_tensor(gt_grid(geom), device=device)


def reprojection_loss(reproj: torch.Tensor, grid: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE between reprojected and identity grids."""
    se = (reproj - grid) ** 2 * mask
    return parallel.global_ratio(se.sum(), mask.sum() * 2, 1)
