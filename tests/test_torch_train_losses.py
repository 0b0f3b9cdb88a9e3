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
