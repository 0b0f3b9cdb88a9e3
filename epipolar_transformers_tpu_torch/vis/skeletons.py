"""Skeleton rendering: 2D/3D human + hand bone drawing (matplotlib-optional).

Equivalents of reference vision/visualizer_human.py:13-231 and
vision/visualizer_hand.py:13-160.  Connectivity/color tables preserved so
plots are comparable; matplotlib is imported lazily (headless-safe).

The port's own copy of epipolar_transformers_tpu/vis/skeletons.py.
"""

from __future__ import annotations

import numpy as np

CONNECTIVITY_DICT = {
    "coco": [(0, 1), (0, 2), (1, 3), (2, 4), (5, 7), (7, 9), (6, 8), (8, 10),
             (11, 13), (13, 15), (12, 14), (14, 16), (5, 6), (5, 11), (6, 12),
             (11, 12)],
    "mpii": [(0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7), (7, 8),
             (8, 9), (8, 12), (8, 13), (10, 11), (11, 12), (13, 14), (14, 15)],
    "human36m": [
        (0, 1), (0, 4), (1, 2), (4, 5), (2, 3), (5, 6), (0, 7), (7, 8),
        (8, 9), (9, 10), (8, 11), (8, 14), (11, 12), (14, 15), (12, 13),
        (15, 16),
    ],
}

# 21-joint hand: wrist/palm + 4 bones per finger (reference visualizer_hand)
HAND_BONES = [
    ((0, 4), (4, 3), (3, 2), (2, 1)),
    ((0, 8), (8, 7), (7, 6), (6, 5)),
    ((0, 12), (12, 11), (11, 10), (10, 9)),
    ((0, 16), (16, 15), (15, 14), (14, 13)),
    ((0, 20), (20, 19), (19, 18), (18, 17)),
]


def draw_2d_pose(keypoints, ax, kind="human36m", keypoints_mask=None,
                 point_size=8, line_width=3, color=None):
    """Draw a 2D skeleton on a matplotlib axis (visualizer_human.py:83-118)."""
    connectivity = CONNECTIVITY_DICT[kind]
    keypoints = np.asarray(keypoints)
    if keypoints_mask is None:
        keypoints_mask = np.ones(len(keypoints), dtype=bool)
    for i, (a, b) in enumerate(connectivity):
        if keypoints_mask[a] and keypoints_mask[b]:
            xs = [keypoints[a, 0], keypoints[b, 0]]
            ys = [keypoints[a, 1], keypoints[b, 1]]
            ax.plot(xs, ys, lw=line_width, c=color or "b")
    ax.scatter(keypoints[keypoints_mask, 0], keypoints[keypoints_mask, 1],
               s=point_size, c="red")


def draw_3d_pose(keypoints, ax, kind="human36m", keypoints_mask=None,
                 point_size=2, line_width=2):
    """3D skeleton on a 3D axis (visualizer_human.py:175-231)."""
    connectivity = CONNECTIVITY_DICT[kind]
    keypoints = np.asarray(keypoints)
    if keypoints_mask is None:
        keypoints_mask = np.ones(len(keypoints), dtype=bool)
    for a, b in connectivity:
        if keypoints_mask[a] and keypoints_mask[b]:
            ax.plot([keypoints[a, 0], keypoints[b, 0]],
                    [keypoints[a, 1], keypoints[b, 1]],
                    [keypoints[a, 2], keypoints[b, 2]], lw=line_width)
    ax.scatter(keypoints[keypoints_mask, 0], keypoints[keypoints_mask, 1],
               keypoints[keypoints_mask, 2], s=point_size, c="red")


def plot_hand_3d(coords_xyz, axis, occlusion=None, color_fixed=None, linewidth=1):
    """21-joint hand skeleton in 3D (visualizer_hand.py:107-121)."""
    coords_xyz = np.asarray(coords_xyz)
    for f, finger in enumerate(HAND_BONES):
        for a, b in finger:
            if occlusion is not None and not (occlusion[a] and occlusion[b]):
                continue
            axis.plot([coords_xyz[a, 0], coords_xyz[b, 0]],
                      [coords_xyz[a, 1], coords_xyz[b, 1]],
                      [coords_xyz[a, 2], coords_xyz[b, 2]],
                      color=color_fixed or f"C{f}", linewidth=linewidth)


def plot_single_hand_2d(keypoints, ax, occlusion=None, color_fixed=None, linewidth=1):
    """visualizer_hand.py:123-139."""
    keypoints = np.asarray(keypoints)
    for f, finger in enumerate(HAND_BONES):
        for a, b in finger:
            if occlusion is not None and not (occlusion[a] and occlusion[b]):
                continue
            ax.plot([keypoints[a, 0], keypoints[b, 0]],
                    [keypoints[a, 1], keypoints[b, 1]],
                    color=color_fixed or f"C{f}", linewidth=linewidth)


def plot_two_hand_2d(keypoints, ax, occlusion=None, **kw):
    """42-joint two-hand drawing (visualizer_hand.py:141-160)."""
    plot_single_hand_2d(keypoints[:21], ax,
                        occlusion[:21] if occlusion is not None else None, **kw)
    plot_single_hand_2d(keypoints[21:], ax,
                        occlusion[21:] if occlusion is not None else None, **kw)
