"""2D heatmap losses (PyTorch, NCHW).

Port of epipolar_transformers_tpu/losses/heatmap_loss.py (reference
modeling/metrics/metrics2d.py:18-90).  The JAX versions take NHWC heatmaps;
these take (N, J, H, W).  Visibility is (N, J), or (N, J, 1|3) whose first
column marks a visible joint.

A loss divided by a count that the data sets (the visible joints, the mask)
takes that count over the global batch under a process group
(`parallel.global_ratio`), as GSPMD does in the JAX package; the mean
losses need nothing, since every rank holds as many items.
"""

from __future__ import annotations

import torch

from .. import parallel


def _vis2d(visibility: torch.Tensor, n: int, j: int) -> torch.Tensor:
    """Visibility as (N, J) float32."""
    v = torch.as_tensor(visibility)
    if v.ndim == 3:
        v = v[..., 0]
    return v.reshape(n, j).float()


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor, visibility: torch.Tensor,
                    per_joint_sum: bool = True) -> torch.Tensor:
    """JointsMSELoss (metrics2d.py:18-41): per-joint MSE of the
    visibility-weighted heatmaps, summed over joints, or averaged
    (LOSS_PER_JOINT=False).  The reference weights both maps, so the weight
    enters squared."""
    N, J = pred.shape[:2]
    v = _vis2d(visibility, N, J)[:, :, None, None]
    diff = (pred.float() - target.float()) * v
    loss = (diff ** 2).mean(dim=(0, 2, 3)).sum()
    return loss if per_joint_sum else loss / J


def keypoints_mse_smooth_loss(pred: torch.Tensor, target: torch.Tensor,
                              visibility: torch.Tensor, threshold: float = 400.0) -> torch.Tensor:
    """KeypointsMSESmoothLoss (metrics2d.py:43-58).  The power is taken of
    the squared error clamped to `threshold`, so the branch `where` leaves
    out has a finite derivative: JAX's `diff ** 0.1` on all of `diff` gives
    a NaN gradient wherever the error is exactly 0, as on every pixel of a
    joint with visibility 0.  The loss is the same."""
    N, J, H, W = pred.shape
    v = _vis2d(visibility, N, J)
    diff = (target.float() - pred.float()) ** 2 * v[:, :, None, None]
    over = diff > threshold
    diff = torch.where(over, torch.where(over, diff, threshold) ** 0.1 * threshold ** 0.9, diff)
    return parallel.global_ratio(diff.sum(), v.sum(), 1.0) / (H * W)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor, mask=None) -> torch.Tensor:
    """MaskedMSELoss with 'mean' reduction (metrics2d.py:61-81)."""
    se = (pred.float() - target.float()) ** 2
    if mask is None:
        return se.mean()
    m = torch.as_tensor(mask, device=se.device).bool()
    return parallel.global_ratio(torch.where(m, se, torch.zeros_like(se)).sum(), m.sum(), 1)


def compute_stage_loss(pred_stages, target, mask=None):
    """Per-stage masked MSE (metrics2d.py:83-90): (total, [per stage])."""
    stage_losses = [masked_mse_loss(p, target, mask) for p in pred_stages]
    return sum(stage_losses), stage_losses
