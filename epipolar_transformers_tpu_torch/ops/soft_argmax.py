"""Soft-argmax heatmap peak decoding (PyTorch, batched).

Port of epipolar_transformers_tpu/ops/soft_argmax.py (reference
`find_tensor_peak_batch`, modeling/backbones/basic_batch.py:17-63): take
the argmax pixel, bilinearly sample a (2r+1)^2 window centred on it (zero
padding outside the map), threshold, and return the thresholded window's
weighted centroid mapped to image coordinates with `pix2coord`.  The window
is a separable bilinear crop, computed as two profile products.

Also `get_max_preds` (basic_batch.py:67-95), in numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry.camera import pix2coord
from .quad_gather import axis_slot_weights


def _axis_profile(center: torch.Tensor, offsets: torch.Tensor, size: int) -> torch.Tensor:
    """(...,) centres and (R,) offsets -> (..., R, size) bilinear profiles
    with out-of-range corners exactly zero."""
    pos = center[..., None] + offsets
    base, w0, w1 = axis_slot_weights(pos, size)
    i = torch.arange(size, device=center.device)
    b = base[..., None]
    zero = torch.zeros((), dtype=w0.dtype, device=w0.device)
    return (torch.where(i == b, w0[..., None], zero)
            + torch.where(i == b + 1, w1[..., None], zero))


@functools.cache
def _offsets(radius: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The window's (2r+1,) offsets on `device`, made once (a host copy,
    which a CUDA graph's capture cannot hold); a normal tensor even under
    inference_mode, so that training may use it too."""
    iradius = int(radius + 0.5)
    # torch.arange(-radius, radius + 1e-4, radius / Iradius): 2*Iradius+1 steps
    with torch.inference_mode(False):
        return torch.as_tensor(np.arange(-radius, radius + 1e-4, radius * 1.0 / iradius),
                               dtype=dtype, device=device)


def find_tensor_peak_batch(heatmaps: torch.Tensor, radius: float, downsample: int,
                           threshold: float = 1e-6):
    """Decode (..., H, W) heatmaps -> ((..., 2) xy image coords, (...) scores)."""
    H, W = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], H * W)
    index = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, -1, index[..., None])[..., 0]
    index_w = (index % W).to(heatmaps.dtype)
    index_h = torch.div(index, W, rounding_mode="floor").to(heatmaps.dtype)

    offsets = _offsets(float(radius), heatmaps.dtype, heatmaps.device)
    py = _axis_profile(index_h, offsets, H)  # (..., R, H)
    px = _axis_profile(index_w, offsets, W)  # (..., R, W)
    sub = py @ heatmaps @ px.transpose(-1, -2)  # (..., R, R) rows y, cols x
    # F.threshold(x, thr, 0): keep x where x > thr else 0 (basic_batch.py:52)
    sub = torch.where(sub > threshold, sub, torch.zeros_like(sub))

    sum_region = sub.sum((-1, -2)) + float(np.finfo(np.float64).eps)
    x = (sub * offsets).sum((-1, -2)) / sum_region + index_w
    y = (sub * offsets[:, None]).sum((-1, -2)) / sum_region + index_h
    return torch.stack([pix2coord(x, downsample), pix2coord(y, downsample)], -1), score


def get_max_preds(batch_heatmaps: np.ndarray):
    """Hard argmax decode for (N, J, H, W) numpy heatmaps.

    Returns preds (N, J, 2) xy and maxvals (N, J, 1).
    """
    if batch_heatmaps.ndim != 4:
        raise ValueError(f"expected (N, J, H, W) heatmaps, got {batch_heatmaps.shape}")
    N, J, _, W = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(N, J, -1)
    idx = np.argmax(flat, axis=2)
    maxvals = np.amax(flat, axis=2).reshape(N, J, 1)
    preds = np.tile(idx.reshape(N, J, 1), (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = preds[:, :, 0] % W
    preds[:, :, 1] = np.floor(preds[:, :, 1] / W)
    pred_mask = np.tile(np.greater(maxvals, 0.0), (1, 1, 2)).astype(np.float32)
    preds *= pred_mask
    return preds, maxvals
