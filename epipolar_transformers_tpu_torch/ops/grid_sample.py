"""Bilinear grid sampling, channels-last, behind the JAX package's signature.

Port of epipolar_transformers_tpu/ops/grid_sample.py, which reimplements
torch's `F.grid_sample` (the reference's own op, at its pre-1.4 default of
`align_corners=True` and zero padding) in JAX.  Here it is `F.grid_sample`
itself, the library call, with the layouts translated: the JAX functions
take channels-last images and a `(..., 2)` grid of normalized (x, y),
`F.grid_sample` takes (N, C, H, W) images and an (N, Ho, Wo, 2) grid.
Out-of-range corners contribute exact zeros on both.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def grid_sample_nhwc(images: torch.Tensor, grids: torch.Tensor,
                     align_corners: bool = True) -> torch.Tensor:
    """images (N, H, W, C), grids (N, ..., 2) normalized (x, y) in (-1, 1),
    x indexing W and y indexing H -> (N, ..., C) bilinear samples."""
    N, C = images.shape[0], images.shape[-1]
    lead = grids.shape[1:-1]
    out = F.grid_sample(images.permute(0, 3, 1, 2), grids.reshape(N, -1, 1, 2).to(images.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=align_corners)
    return out[..., 0].transpose(1, 2).reshape(N, *lead, C)


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """One image (H, W, C) sampled at a (..., 2) grid -> (..., C)."""
    return grid_sample_nhwc(image[None], grid[None], align_corners)[0]
