"""Port soft-argmax decode == the JAX package's, and == the reference golden.

Both sides compute in f32 with the same window profiles; tolerance 1e-5
(locations in image pixels, scores in heatmap units).
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops import soft_argmax as jsa
from epipolar_transformers_tpu_torch.ops import soft_argmax as tsa

TOL = dict(rtol=1e-5, atol=1e-5)


def _peaked(rng, J=6, H=16, W=12, peaks=None):
    """Gaussian blobs at `peaks` (y, x) on noise: includes edge and corner
    peaks, whose decode window runs off the map."""
    y, x = np.mgrid[0:H, 0:W]
    if peaks is None:
        peaks = [(0, 0), (H - 1, W - 1), (0, W // 2), (H // 2, 0), (H - 1, 3), (7, 5)]
    maps = []
    for cy, cx in peaks[:J]:
        cy, cx = cy + rng.uniform(-0.4, 0.4), cx + rng.uniform(-0.4, 0.4)
        maps.append(np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 4.0) + 0.01 * rng.randn(H, W))
    return np.stack(maps).astype(np.float32)


@pytest.mark.parametrize("radius,downsample", [(2.0, 4), (8.0, 4), (3.0, 1)])
def test_decode_matches_jax(rng, radius, downsample):
    hm = _peaked(rng)
    want_locs, want_scores = jsa.find_tensor_peak_batch(jnp.asarray(hm), radius, downsample)
    # the port decodes any leading batch dims at once
    locs, scores = tsa.find_tensor_peak_batch(torch.from_numpy(np.stack([hm, hm[::-1]])),
                                              radius, downsample)
    np.testing.assert_allclose(locs[0].numpy(), np.asarray(want_locs), **TOL)
    np.testing.assert_allclose(scores[0].numpy(), np.asarray(want_scores), **TOL)
    back_locs, _ = jsa.find_tensor_peak_batch(jnp.asarray(hm[::-1].copy()), radius, downsample)
    np.testing.assert_allclose(locs[1].numpy(), np.asarray(back_locs), **TOL)


def test_decode_matches_reference_golden():
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "peak_decode_golden.npz"))
    locs, scos = tsa.find_tensor_peak_batch(torch.from_numpy(g["heatmap"]),
                                            float(g["sigma"]), int(g["downsample"]))
    np.testing.assert_allclose(scos.numpy(), g["scos"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(locs.numpy(), g["locs"], rtol=1e-4, atol=2e-3)


def test_get_max_preds_matches_jax(rng):
    hm = rng.randn(3, 4, 9, 7).astype(np.float32)
    hm[0, 1] = -1.0  # all-negative map: the prediction is masked to (0, 0)
    for a, b in zip(tsa.get_max_preds(hm), jsa.get_max_preds(hm)):
        np.testing.assert_array_equal(a, b)
