"""Affine crop helpers (numpy, cv2-free) of the synthetic and H36M datasets.

The port's own copy of `get_affine_transform` and `affine_transform_pts`
from epipolar_transformers_tpu/data/transforms/affine.py (reference
data/transforms/image.py:218-304).  The only cv2 call there
(cv2.getAffineTransform) is a 3-point linear solve, done with numpy.  Also
its ImageNet normalization constants (RGB).
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def get_dir(src_point, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return [
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ]


def get_3rd_point(a, b):
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def _affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """2x3 affine mapping 3 src points to 3 dst points (== cv2.getAffineTransform)."""
    A = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    T = np.linalg.solve(A, dst)  # (3, 2)
    return T.T  # (2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.array([0, 0], dtype=np.float32), inv=0):
    """reference image.py:226-258 (scale unit = 200px boxes)."""
    if not isinstance(scale, (np.ndarray, list)):
        scale = np.array([scale, scale])
    scale = np.asarray(scale, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180
    src_dir = get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0, :] = center + scale_tmp * shift
    src[1, :] = center + src_dir + scale_tmp * shift
    dst[0, :] = [dst_w * 0.5, dst_h * 0.5]
    dst[1, :] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir
    src[2:, :] = get_3rd_point(src[0, :], src[1, :])
    dst[2:, :] = get_3rd_point(dst[0, :], dst[1, :])

    if inv:
        return _affine_from_points(dst, src)
    return _affine_from_points(src, dst)


def affine_transform(pt, t):
    new_pt = np.array([pt[0], pt[1], 1.0])
    return (t @ new_pt)[:2]


def affine_transform_pts(pts, t):
    """(N, 2) points through a 2x3 affine."""
    pts = np.asarray(pts)
    homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (t @ homo.T).T[:, :2]


def de_normalize_image(img_hwc: np.ndarray) -> np.ndarray:
    """An ImageNet-normalized (H, W, 3) image back to [0, 1] RGB."""
    return img_hwc * IMAGENET_STD + IMAGENET_MEAN
