"""3D keypoint transforms for the hand-lifting tasks (numpy).

The port's own copy of epipolar_transformers_tpu/data/transforms/
keypoints3d.py (reference data/transforms/keypoints3d.py):
palm-coordinate merge, canonical-frame normalization via three Euler
rotations, handedness flip, and the numerically-hardened atan2.
tests/test_torch_lifting.py holds it equal to the JAX package's copy and
to keypoints3d_golden.npz.
"""

from __future__ import annotations

import numpy as np


def palm_coord(keypoint_xyz: np.ndarray) -> np.ndarray:
    """Replace both wrists with palm centers ((kp0+kp12)/2) — 42-point input.

    reference keypoints3d.py:4-10."""
    palm_l = 0.5 * (keypoint_xyz[0] + keypoint_xyz[12])
    palm_r = 0.5 * (keypoint_xyz[21] + keypoint_xyz[33])
    return np.vstack([palm_l[None], keypoint_xyz[1:21], palm_r[None], keypoint_xyz[-20:]])


def palm_coord_singlehand(keypoint_xyz: np.ndarray) -> np.ndarray:
    palm = 0.5 * (keypoint_xyz[0] + keypoint_xyz[12])
    return np.vstack([palm[None], keypoint_xyz[1:21]])


def flip_hand(coords: np.ndarray) -> np.ndarray:
    """Mirror z (reference keypoints3d.py:19-28)."""
    out = coords.copy()
    out[..., 2] = -out[..., 2]
    return out


def atan2(y, x):
    """The reference's hardened scalar atan2 (keypoints3d.py:140-155)."""
    tan = np.arctan(y / (x + 1e-8))
    tan_c = tan + (np.pi if x + 1e-8 < 0.0 else 0.0)
    tan_zero_2pi = tan_c + (2 * np.pi if tan_c < 0.0 else 0.0)
    return tan_zero_2pi + (-2 * np.pi if tan_zero_2pi > np.pi else 0.0)


def _rot_x(a):
    return np.array([[1, 0, 0], [0, np.cos(a), np.sin(a)], [0, -np.sin(a), np.cos(a)]])


def _rot_y(a):
    return np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])


def _rot_z(a):
    return np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0], [0, 0, 1]])


def canonical_trafo(coords_xyz: np.ndarray):
    """Rotate a normalized 21-joint hand into its canonical frame.

    reference keypoints3d.py:30-73: root at origin, middle-finger base on the
    y axis, pinky base defining the y-rotation; returns (canonical coords,
    rotation matrix with canonical @ rot == input).
    """
    assert coords_xyz.shape == (21, 3), coords_xyz.shape
    ALIGN, ROT = 12, 20

    p = coords_xyz[ALIGN]
    alpha = atan2(p[0], p[1])
    rot = _rot_z(alpha)
    r1 = coords_xyz @ rot
    total = rot

    p1 = r1[ALIGN]
    beta = -atan2(p1[2], p1[1])
    rot = _rot_x(beta + np.pi)
    r2 = r1 @ rot
    total = total @ rot

    p2 = r2[ROT]
    gamma = atan2(p2[2], p2[0])
    rot = _rot_y(gamma)
    normed = r2 @ rot
    total = total @ rot
    return normed, np.linalg.inv(total)
