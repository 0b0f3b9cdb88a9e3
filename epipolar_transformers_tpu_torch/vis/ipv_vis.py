"""Notebook 3D visualization: point clouds + camera frusta.

Equivalent of reference vision/ipv_vis.py (ipyvolume-based).  ipyvolume is
not part of this image, so the drawing functions degrade to returning the
geometry they would plot (and plot only when ipyvolume imports).

The port's own copy of epipolar_transformers_tpu/vis/ipv_vis.py.
"""

from __future__ import annotations

import numpy as np


def _try_ipv():
    try:
        import ipyvolume as ipv  # noqa: F401

        return ipv
    except ImportError:
        return None


def camera_frustum_lines(K, R, T, scale: float = 200.0) -> np.ndarray:
    """(8, 2, 3) line segments of a camera frustum in world coords.

    T is the camera center; R maps world->camera rows."""
    K = np.asarray(K)
    R = np.asarray(R)
    C = np.asarray(T).reshape(3)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    # image corners at unit depth, scaled
    corners_cam = np.array(
        [[(x - cx) / fx, (y - cy) / fy, 1.0] for x, y in
         [(0, 0), (2 * cx, 0), (2 * cx, 2 * cy), (0, 2 * cy)]]
    ) * scale
    corners = (R.T @ corners_cam.T).T + C
    lines = [np.stack([C, c]) for c in corners]
    for i in range(4):
        lines.append(np.stack([corners[i], corners[(i + 1) % 4]]))
    return np.stack(lines)


def plot_scene(points3d=None, cameras=None, scale: float = 200.0):
    """Plot a point cloud and camera frusta in a notebook; headless-safe.

    Args:
        points3d: (N, 3) world points.
        cameras: list of (K, R, T_center).
    Returns:
        dict with the geometry (and the ipyvolume figure when available).
    """
    frusta = [camera_frustum_lines(*cam, scale=scale) for cam in (cameras or [])]
    out = {"points": None if points3d is None else np.asarray(points3d),
           "frusta": frusta, "figure": None}
    ipv = _try_ipv()
    if ipv is None:
        return out
    fig = ipv.figure()
    if points3d is not None:
        p = np.asarray(points3d)
        ipv.scatter(p[:, 0], p[:, 1], p[:, 2], marker="sphere", size=2)
    for f in frusta:
        for seg in f:
            ipv.plot(seg[:, 0], seg[:, 1], seg[:, 2])
    out["figure"] = fig
    ipv.show()
    return out
