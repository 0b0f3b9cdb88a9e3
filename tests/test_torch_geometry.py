"""Port camera math and epipolar sample locations == the JAX package.

Inputs are made with numpy from a seed and handed to both packages as f32
(x64 is on in this suite, so the JAX side is cast explicitly).  Tolerances:
both sides compute in f32 through the same formulas in another operation
order, ~1e-6 relative; sample locations are normalized coordinates, where
1e-4 is ~0.003 feature pixel at 64 px.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.geometry import camera as jcam
from epipolar_transformers_tpu.ops import epipolar_sampling as jsamp
from epipolar_transformers_tpu_torch.geometry import camera as tcam
from epipolar_transformers_tpu_torch.ops import epipolar_sampling as tsamp

TOL = dict(rtol=1e-5, atol=1e-5)
LOC_TOL = dict(rtol=1e-4, atol=1e-4)


def _random_rig(rng, n):
    """n random projections K[R | -R C] with centres ~4 m away."""
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        R = q * np.sign(np.linalg.det(q))
        C = rng.randn(3) * 4000.0
        K = np.array([[rng.uniform(200, 1200), 0, rng.uniform(20, 40)],
                      [0, rng.uniform(200, 1200), rng.uniform(20, 40)], [0, 0, 1]])
        out.append(K @ np.concatenate([R, -R @ C[:, None]], 1))
    return np.stack(out).astype(np.float32)


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("source", ["ring", "random"])
def test_camera_helpers_match_jax(source, camera_ring, rng):
    P = camera_ring["KRT"].astype(np.float32) if source == "ring" else _random_rig(rng, 6)
    np.testing.assert_allclose(tcam.inv3x3(_t(P[:, :, :3])).numpy(),
                               np.asarray(jcam.inv3x3(_j(P[:, :, :3]))), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tcam.pinv34(_t(P)).numpy(),
                               np.asarray(jcam.pinv34(_j(P))), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tcam.camera_center(_t(P)).numpy(),
                               np.asarray(jcam.camera_center(_j(P))), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(tcam.camera_center_h(_t(P)).numpy(),
                               np.asarray(jcam.camera_center_h(_j(P))), rtol=1e-4, atol=1e-2)
    pts = rng.uniform(-3, 20, (5, 7, 2)).astype(np.float32)
    for correct in (True, False):
        for fn in ("normalize_pixel", "denormalize_pixel"):
            np.testing.assert_allclose(
                getattr(tcam, fn)(_t(pts), 12, 17, correct=correct).numpy(),
                np.asarray(getattr(jcam, fn)(_j(pts), 12, 17, correct=correct)), **TOL)
    np.testing.assert_allclose(tcam.pix2coord(_t(pts), 4).numpy(),
                               np.asarray(jcam.pix2coord(_j(pts), 4)), **TOL)
    np.testing.assert_allclose(tcam.coord2pix(_t(pts), 4).numpy(),
                               np.asarray(jcam.coord2pix(_j(pts), 4)), **TOL)
    want = jcam.neighbor_cameras({i: P[i] for i in range(len(P))})
    got = tcam.neighbor_cameras({i: P[i] for i in range(len(P))})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k][0] == want[k][0]
        np.testing.assert_allclose(got[k][1], want[k][1])


def _sample_locs_both(P1, P2, geom):
    want = np.stack([np.asarray(jsamp.epipolar_sample_locs(_j(a), _j(b), geom))
                     for a, b in zip(P1, P2)])
    got = tsamp.epipolar_sample_locs(_t(P1), _t(P2), geom).numpy()
    assert got.dtype == np.float32
    return got, want


@pytest.mark.parametrize("correct", [True, False])
def test_sample_locs_match_jax_on_ring(camera_ring, correct):
    P = camera_ring["KRT"].astype(np.float32)
    geom = tsamp.EpipolarGeometry(feat_h=16, feat_w=16, sample_size=16, downsample=4,
                                  resize=1.0, correct_normalize=correct)
    pairs = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]
    got, want = _sample_locs_both(P[[a for a, _ in pairs]], P[[b for _, b in pairs]], geom)
    assert got.shape == (len(pairs), 16, 16, 16, 2)
    np.testing.assert_allclose(got, want, **LOC_TOL)


def test_sample_locs_match_jax_on_random_rigs(rng):
    """Random rigs give clipped lines and lines that miss the image (sent
    far out of range)."""
    geom = tsamp.EpipolarGeometry(feat_h=12, feat_w=10, sample_size=8, downsample=4,
                                  resize=1.0, correct_normalize=True)
    P = _random_rig(rng, 16)
    got, want = _sample_locs_both(P[:8], P[8:], geom)
    missed = (np.abs(want) > 100).all(-1).all(1)  # (N, H, W) lines that miss
    assert missed.any() and (~missed).any()
    np.testing.assert_array_equal(missed, (np.abs(got) > 100).all(-1).all(1))
    np.testing.assert_allclose(got, want, **LOC_TOL)


def test_sample_locs_match_reference_golden():
    """The port's geometry against the reference's grid2sample_locs dump,
    with the bounds the JAX package's own golden test uses."""
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "epipolar_golden.npz"))
    geom = tsamp.EpipolarGeometry(feat_h=16, feat_w=16, sample_size=int(g["samplesize"]),
                                  downsample=int(g["downsample"]), resize=1.0,
                                  correct_normalize=True)
    ours = tsamp.epipolar_sample_locs(_t(g["P1"][:1]), _t(g["P2"][:1]), geom)[0].numpy()
    ref = g["avg_dot_correct__sample_locs"][:, 0]
    valid_ref = (np.abs(ref) < 2).all(-1)
    valid_ours = (np.abs(ours) < 2).all(-1)
    assert (valid_ref != valid_ours).mean() < 0.02
    diff = np.abs(ours - ref)[valid_ref & valid_ours]
    assert diff.mean() < 0.01
    assert np.quantile(diff, 0.95) < 0.034
