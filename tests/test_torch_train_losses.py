"""The port's heatmap losses (NCHW) == the JAX package's (NHWC) on the same
seeded heatmaps and visibility, for every KEYPOINT.LOSS the builder keys:
'joint' (LOSS_PER_JOINT on and off), 'smoothmse' and the per-stage masked
MSE, with and without a mask.  Both sides are f32 and differ in summation
order only: rtol 1e-6.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.losses import heatmap_loss as jloss
from epipolar_transformers_tpu_torch.losses import heatmap_loss as tloss

N, J, H, W = 3, 5, 8, 6


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("case", ["joint_sum", "joint_mean", "smooth", "stage", "stage_masked"])
def test_loss_matches_jax(rng, case):
    pred, target = (rng.randn(N, J, H, W).astype(np.float32) * 30 for _ in range(2))
    vis = (rng.rand(N, J, 1) > 0.3).astype(np.float32)
    mask = rng.rand(N, J, H, W) > 0.5
    tp, tt, tv = map(torch.from_numpy, (pred, target, vis))
    if case.startswith("joint"):
        per_joint = case == "joint_sum"
        want = jloss.joints_mse_loss(_nhwc(pred), _nhwc(target), vis, per_joint_sum=per_joint)
        got = tloss.joints_mse_loss(tp, tt, tv, per_joint_sum=per_joint)
    elif case == "smooth":
        want = jloss.keypoints_mse_smooth_loss(_nhwc(pred), _nhwc(target), vis)
        got = tloss.keypoints_mse_smooth_loss(tp, tt, tv)
    else:
        m = mask if case == "stage_masked" else None
        want, want_stages = jloss.compute_stage_loss(
            [_nhwc(pred), _nhwc(pred[::-1].copy())], _nhwc(target),
            None if m is None else _nhwc(m))
        got, got_stages = tloss.compute_stage_loss(
            [tp, torch.from_numpy(pred[::-1].copy())], tt,
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose([float(s) for s in got_stages],
                                   [float(s) for s in want_stages], rtol=1e-6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_smooth_loss_gradient_is_finite_where_a_joint_is_invisible(rng):
    """The smooth MSE loss's gradient on heatmaps with joints of visibility
    exactly 0 (a squared error of exactly 0 on their pixels): finite
    everywhere in the port, and equal to `jax.grad` wherever JAX's is
    finite; JAX's `diff ** 0.1` is NaN on those pixels.  Errors on both
    sides of the threshold."""
    import jax

    pred, target = (rng.randn(N, J, H, W).astype(np.float32) * 30 for _ in range(2))
    vis = (rng.rand(N, J, 1) > 0.3).astype(np.float32)
    vis[0, :2] = 0.0
    want = np.asarray(jax.grad(
        lambda p: jloss.keypoints_mse_smooth_loss(p, _nhwc(target), vis))(_nhwc(pred)))
    want = np.transpose(want, (0, 3, 1, 2))
    tp = torch.from_numpy(pred).requires_grad_()
    loss = tloss.keypoints_mse_smooth_loss(tp, torch.from_numpy(target), torch.from_numpy(vis))
    loss.backward()
    got = tp.grad.numpy()
    assert np.isnan(want).any()  # the trap is there on the JAX side
    assert np.isfinite(got).all()
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-9)
    assert (got[~finite] == 0).all()  # the invisible joints' pixels
    # the forward is the one JAX's form gives, bit for bit, in the port's order
    v = torch.from_numpy(vis)[..., 0]
    diff = (torch.from_numpy(target) - torch.from_numpy(pred)) ** 2 * v[:, :, None, None]
    plain = torch.where(diff > 400.0, diff ** 0.1 * 400.0 ** 0.9, diff)
    assert torch.equal(loss.detach(), plain.sum() / v.sum() / (H * W))
    squared = (target - pred) ** 2 * vis[..., None]
    assert (squared > 400).any() and ((squared <= 400) & (squared > 0)).any()
