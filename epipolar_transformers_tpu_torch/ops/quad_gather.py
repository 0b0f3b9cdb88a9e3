"""Bilinear slot weights with exact zero-padding semantics.

Port of `_axis_slot_weights` from epipolar_transformers_tpu/ops/
quad_gather.py.  Its edge rules are what make the attention's zero
sentinel exact: a corner outside [0, size-1] gets weight exactly 0, so a
sample with every corner outside the image has similarity exactly 0.0.
The CUDA kernel (csrc/epipolar_attention.cu) computes the same rules.
"""

from __future__ import annotations

import torch


def axis_slot_weights(coord: torch.Tensor, size: int):
    """Per-axis (base, w0, w1) for one coordinate tensor.

    base lies in [0, size-1]; w0/w1 are the weights of the slot-0/slot-1
    corners along this axis, zero for a corner outside [0, size-1].  When
    floor(coord) == -1 the valid corner moves into slot 0 with its weight.
    """
    c0 = torch.floor(coord)
    frac = coord - c0
    base = torch.clamp(c0, 0, size - 1).to(torch.int64)
    shifted = c0 < 0
    valid0 = (c0 >= 0) & (c0 <= size - 1)
    valid1 = (c0 + 1 >= 0) & (c0 + 1 <= size - 1)
    zero = torch.zeros_like(frac)
    w0 = torch.where(shifted, torch.where(valid1, frac, zero),
                     torch.where(valid0, 1.0 - frac, zero))
    w1 = torch.where(shifted, zero, torch.where(valid1, frac, zero))
    return base, w0, w1
