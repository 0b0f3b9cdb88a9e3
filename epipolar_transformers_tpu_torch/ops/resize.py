"""Bilinear resize with align_corners=True (PyTorch, NCHW).

Port of epipolar_transformers_tpu/ops/resize.py, the hourglass's upsample
(reference ProHG.py:118).  The JAX package builds it from two separable
interpolation matmuls for the TPU's matrix unit; torch computes the same
function directly.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """x: (N, C, H, W) -> (N, C, H_out, W_out); the identity at equal size."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)
