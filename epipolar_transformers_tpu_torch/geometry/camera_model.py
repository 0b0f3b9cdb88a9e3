"""Full pinhole camera model with distortion (numpy, host-side).

The port's own copy of epipolar_transformers_tpu/geometry/camera_model.py.
Equivalent of the reference's vendored pymvg `CameraModel` +
`MultiCameraSystem` (vision/camera_model.py:79-1095,
vision/multi_camera_system.py:22-284), reduced to the functionality the
pipeline actually exercises: K/R/t composition, plumb-bob distortion,
project / unproject / undistort / distort, construction from a raw 3x4 M via
RQ decomposition, and multi-camera DLT triangulation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .host import dlt_triangulate_np


def rq_decomposition(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RQ decompose a 3x3 matrix into upper-triangular R and orthonormal Q
    with positive diagonal on R (camera K convention)."""
    # RQ via QR of the flipped matrix
    P = np.fliplr(np.eye(3))
    q, r = np.linalg.qr((P @ M).T)
    Rm = P @ r.T @ P
    Qm = P @ q.T
    # enforce positive diagonal of K
    signs = np.sign(np.diag(Rm))
    signs[signs == 0] = 1
    S = np.diag(signs)
    return Rm @ S, S @ Qm


class CameraModel:
    """K (3,3) intrinsics, R (3,3) world->cam rotation, t (3,) translation
    (x_cam = R X + t), optional plumb-bob distortion [k1, k2, p1, p2, k3]."""

    def __init__(self, K, R, t, distortion=None, name: str = ""):
        self.K = np.asarray(K, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.t = np.asarray(t, dtype=np.float64).reshape(3)
        self.D = (np.zeros(5) if distortion is None
                  else np.asarray(distortion, dtype=np.float64).reshape(-1))
        if self.D.size < 5:
            self.D = np.concatenate([self.D, np.zeros(5 - self.D.size)])
        self.name = name

    # -------------------------------------------------- constructors
    @classmethod
    def from_M(cls, M: np.ndarray, name: str = "") -> "CameraModel":
        """Projection matrix -> (K, R, t) via RQ (reference
        camera_model.py:392-439 load_camera_from_M)."""
        M = np.asarray(M, dtype=np.float64)
        K, R = rq_decomposition(M[:, :3])
        t = np.linalg.solve(K, M[:, 3])
        if np.linalg.det(R) < 0:  # keep a proper rotation
            R = -R
            t = -t
        K = K / K[2, 2]
        return cls(K, R, t * (1.0 if K[2, 2] > 0 else -1.0), name=name)

    @classmethod
    def from_KRt(cls, K, R, t, distortion=None, name: str = "") -> "CameraModel":
        return cls(K, R, t, distortion, name)

    # -------------------------------------------------- basics
    def get_M(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t.reshape(3, 1)], axis=1)

    def center(self) -> np.ndarray:
        return -self.R.T @ self.t

    # -------------------------------------------------- distortion
    def _distort_normalized(self, xy: np.ndarray) -> np.ndarray:
        k1, k2, p1, p2, k3 = self.D[:5]
        x, y = xy[:, 0], xy[:, 1]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=1)

    def distort(self, pts: np.ndarray) -> np.ndarray:
        """Ideal pixel coords -> distorted pixel coords."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        norm = np.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], axis=1)
        d = self._distort_normalized(norm)
        return np.stack([d[:, 0] * fx + cx, d[:, 1] * fy + cy], axis=1)

    def undistort(self, pts: np.ndarray, iters: int = 10) -> np.ndarray:
        """Distorted pixel coords -> ideal pixel coords (fixed-point inverse,
        the cv2.undistortPoints iteration)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        xd = (pts[:, 0] - cx) / fx
        yd = (pts[:, 1] - cy) / fy
        x, y = xd.copy(), yd.copy()
        k1, k2, p1, p2, k3 = self.D[:5]
        for _ in range(iters):
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return np.stack([x * fx + cx, y * fy + cy], axis=1)

    # -------------------------------------------------- projection
    def project_3d_to_pixel(self, pts3d: np.ndarray, distorted: bool = True) -> np.ndarray:
        pts3d = np.atleast_2d(np.asarray(pts3d, dtype=np.float64))
        cam = (self.R @ pts3d.T + self.t.reshape(3, 1))
        norm = (cam[:2] / cam[2]).T
        if distorted and np.any(self.D):
            norm = self._distort_normalized(norm)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        return np.stack([norm[:, 0] * fx + cx, norm[:, 1] * fy + cy], axis=1)

    def project_pixel_to_3d_ray(self, pts: np.ndarray, distorted: bool = True):
        """Pixel -> (unit direction in world coords, camera center)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        if distorted and np.any(self.D):
            pts = self.undistort(pts)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        d_cam = np.stack(
            [(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy, np.ones(len(pts))], axis=1
        )
        d_world = (self.R.T @ d_cam.T).T
        d_world /= np.linalg.norm(d_world, axis=1, keepdims=True)
        return d_world, self.center()


class MultiCameraSystem:
    """Named camera collection with Hartley-Zisserman DLT triangulation
    (reference multi_camera_system.py:199-239)."""

    def __init__(self, cameras: Sequence[CameraModel]):
        self._cameras: Dict[str, CameraModel] = {c.name or str(i): c
                                                 for i, c in enumerate(cameras)}

    def get_names(self) -> List[str]:
        return list(self._cameras)

    def get_camera(self, name: str) -> CameraModel:
        return self._cameras[name]

    def find3d(self, pts: Sequence[Tuple[str, np.ndarray]], undistort: bool = True) -> np.ndarray:
        obs, Ps = [], []
        for name, xy in pts:
            cam = self._cameras[name]
            xy = np.asarray(xy, dtype=np.float64).reshape(2)
            if undistort and np.any(cam.D):
                xy = cam.undistort(xy[None])[0]
            obs.append(xy)
            Ps.append(cam.get_M())
        return dlt_triangulate_np(np.asarray(obs), np.asarray(Ps))

    def find2d(self, camera_name: str, xyz, distorted: bool = True) -> np.ndarray:
        xyz = np.asarray(xyz, dtype=np.float64)
        rank1 = xyz.ndim == 1
        pix = self._cameras[camera_name].project_3d_to_pixel(
            np.atleast_2d(xyz), distorted=distorted
        )
        return pix[0] if rank1 else pix
