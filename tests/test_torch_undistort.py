"""The port's undistortion, crop warp and target heatmaps against cv2 and
the JAX package.

`undistort_points` against the JAX dataset's `undistort_points`
(cv2.undistortPoints, P=K) to 1e-9 px; `undistort_image` and
`remap_bilinear_u8` bit-equal to cv2.undistort and cv2.remap (fixed-point
maps, INTER_LINEAR, zero border).  The cameras have no map coordinate on
an exact 1/64 px tie: there cv2's own map arithmetic (fused multiply-adds
in its vectorised path) may round the 1/32 px step the other way.
`warp_affine` and `render_heatmaps` against JAX runtime/loader.py's (its
native warp.cpp) to 1e-5 (absolute, with 2 f32 ulps relative for images
in 0..255).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from epipolar_transformers_tpu.data.datasets.joints_dataset import (  # noqa: E402
    undistort_points as jax_undistort_points)
from epipolar_transformers_tpu.runtime import loader as jax_loader  # noqa: E402
from epipolar_transformers_tpu_torch.data.transforms.affine import get_affine_transform  # noqa: E402
from epipolar_transformers_tpu_torch.data.transforms.warp import (  # noqa: E402
    render_heatmaps, warp_affine)
from epipolar_transformers_tpu_torch.geometry.undistort import (  # noqa: E402
    remap_bilinear_u8, undistort_image, undistort_points)

# (K, dist): an H36M-like camera with the fake tree's lens, one with no
# distortion, one with strong barrel distortion and an off-centre point
CAMERAS = {
    "h36m": (np.array([[1150.0, 0, 500.3], [0, 1148.0, 499.7], [0, 0, 1]]),
             np.array([-0.207, 0.244, 0.0014, -0.0007, -0.0021])),
    "none": (np.array([[800.0, 0, 100.0], [0, 800.0, 90.0], [0, 0, 1]]), np.zeros(5)),
    "strong": (np.array([[300.0, 0, 41.0], [0, 310.0, 29.5], [0, 0, 1]]),
               np.array([-0.45, 0.31, -0.004, 0.003, -0.08])),
    # a wide-angle lens whose map reaches past int16 pixels, where cv2
    # saturates the map's integer part
    "wide": (np.array([[120.3, 0, 500.7], [0, 125.1, 110.3], [0, 0, 1]]),
             np.array([0.4, 0.5, 0.01, -0.01, 0.3])),
}


@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_undistort_points(camera):
    K, dist = CAMERAS[camera]
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.2, 1.2, (300, 2)) * 2 * K[:2, 2]
    np.testing.assert_allclose(undistort_points(pts, K, dist), jax_undistort_points(pts, K, dist),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("camera,shape", [("h36m", (1000, 1000, 3)), ("h36m", (200, 200, 3)),
                                          ("none", (180, 200, 3)), ("strong", (59, 83, 3)),
                                          ("strong", (59, 83)), ("wide", (243, 1040, 3))])
def test_undistort_image_is_cv2s(camera, shape):
    K, dist = CAMERAS[camera]
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(undistort_image(img, K, dist), cv2.undistort(img, K, dist))


@pytest.mark.parametrize("low,high", [(-3, 75), (-60, 130)])
def test_remap_is_cv2s(low, high):
    """Random fixed-point maps, inside, across and beyond the border."""
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    xy = rng.randint(low, high, (40, 60, 2)).astype(np.int16)
    fxy = rng.randint(0, 1024, (40, 60)).astype(np.uint16)
    want = cv2.remap(img, xy, fxy, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    np.testing.assert_array_equal(remap_bilinear_u8(img, xy, fxy), want)


@pytest.mark.parametrize("rotation", [0.0, 17.3, -40.0])
@pytest.mark.parametrize("grey", [False, True])
def test_warp_affine(rotation, grey):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (300, 280) if grey else (300, 280, 3)).astype(np.float32)
    trans = get_affine_transform(np.array([140.3, 151.7]), np.array([1.1, 1.1]), rotation,
                                 (64, 64))
    want = jax_loader.warp_affine(img, trans, (64, 64))
    got = warp_affine(img, trans, (64, 64))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-5)


@pytest.mark.parametrize("visibility", [False, True])
def test_render_heatmaps(visibility):
    rng = np.random.RandomState(4)
    coords = rng.uniform(-20, 280, (17, 2))
    vis = (rng.rand(17) > 0.3).astype(np.float32) if visibility else None
    want = jax_loader.render_heatmaps(coords, (64, 64), 8.0, 4, visibility=vis)
    np.testing.assert_allclose(render_heatmaps(coords, (64, 64), 8.0, 4, visibility=vis), want,
                               rtol=0, atol=1e-5)
