"""3D end-point-error metrics (PyTorch).

Port of epipolar_transformers_tpu/metrics/metrics3d.py (reference
modeling/metrics/metrics3d.py), on tensors: they run inside the model's
forward, on its device, as in the JAX package.
"""

from __future__ import annotations

import torch


def _as_tensor(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def epe_mean(out: torch.Tensor, target: torch.Tensor, keypoint_vis=None, keypoint_scale=1.0,
             unit=1.0, max_dist: float = 150.0):
    """Mean per-endpoint error in mm, clamped at `max_dist`.

    reference metrics3d.py:5-46.  Faithful quirk: the returned mean is over
    ALL joints (clamped), while visibility only zeroes the returned
    per-joint array, as the reference computes it.

    Args:
        out/target: (..., J, 3).
    Returns:
        (scalar mean, per-joint error of the first batch element with its
        invisible joints zeroed)
    """
    err = torch.sqrt(torch.sum((out - target) ** 2, dim=-1))
    scale = _as_tensor(1.0 if keypoint_scale is None else keypoint_scale, err)
    if scale.ndim >= 1:
        scale = scale[..., None]  # a per-sample scale over the joints
    unit_t = _as_tensor(1.0 if unit is None else unit, err)
    if unit_t.ndim >= 1:
        unit_t = unit_t[..., None]
    err = torch.clamp(err * scale * unit_t, max=max_dist)
    perjoint = err
    if keypoint_vis is not None:
        vis = torch.as_tensor(keypoint_vis, device=err.device)
        while vis.ndim > err.ndim:
            vis = vis[..., 0]
        perjoint = torch.where(vis.bool(), err, torch.zeros_like(err))
    first = perjoint[0] if perjoint.ndim > 1 else perjoint
    return err.mean(), first


def epe_mean_multiview_gt(out: torch.Tensor, target: torch.Tensor, keypoint_vis=None,
                          keypoint_scale=1.0, unit=1.0) -> torch.Tensor:
    """Upper-bound metric: each view's nearest joint error to the ground
    truth, over the visible views (reference metrics3d.py:63-70)."""
    err = torch.sqrt(torch.sum((out - target) ** 2, dim=-1)).amin(dim=1)
    err = err * _as_tensor(keypoint_scale, err) * _as_tensor(unit, err)
    if keypoint_vis is None:
        return err.mean()
    vis = torch.as_tensor(keypoint_vis, device=err.device).bool()
    while vis.ndim > err.ndim:
        vis = vis[..., 0]
    return (torch.where(vis, err, torch.zeros_like(err)).sum()
            / vis.sum().clamp_min(1).to(err.dtype))
