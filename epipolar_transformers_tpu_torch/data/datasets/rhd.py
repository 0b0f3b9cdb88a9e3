"""RHD rendered-hand dataset for the lifting tasks (host, numpy).

Port of epipolar_transformers_tpu/data/datasets/rhd.py (reference
data/datasets/RHD.py:19-285): mask-based dominant-hand selection,
palm-coordinate root, canonical-frame normalization, uv/crop noise
augmentation in training, the hand crop and its resize, and Gaussian
scoremaps.  Items are NHWC, key for key the JAX package's.

Two differences, neither visible in an eval item: the PNGs are read and
the crop resized by the port's own `data/image_io.py` (no cv2), and the
train-time noise comes from a `numpy.random.Generator` seeded per dataset
(`seed`, cfg.SEED from the loader), not from the global `np.random`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from ...config import Config
from ...ops.heatmap import make_heatmap_grid
from ..image_io import read_png, resize_bilinear
from ..transforms.keypoints3d import canonical_trafo, flip_hand, palm_coord


class RHDDataset:
    io_bound = True  # a PNG decode per item

    def __init__(self, cfg: Config, root: str, subset: str = "training",
                 is_train: bool = False, seed: int = 0):
        self.cfg = cfg
        self.is_train = is_train
        with open(os.path.join(root, subset, f"anno_{subset}.pickle"), "rb") as f:
            self.anno_all = pickle.load(f)
        self.ids = list(self.anno_all)
        self.root = os.path.join(root, subset)
        self.rng = np.random.default_rng(seed)
        self.coord_uv_noise_sigma = 2.5
        self.crop_center_noise_sigma = 20.0
        self.crop_offset_noise_sigma = 10.0
        self.crop_size = cfg.LIFTING.CROP_SIZE
        self.image_size = cfg.LIFTING.IMAGE_SIZE
        self.unit = 1000.0
        # the reference's Heatmapcreator downsamples by 4
        self._hm_grid = make_heatmap_grid(tuple(cfg.KEYPOINT.HEATMAP_SIZE), 4, cfg.KEYPOINT.SIGMA)
        self.sigma = cfg.KEYPOINT.SIGMA

    def __len__(self):
        return len(self.ids)

    def _read(self, kind: str, sample_id: int) -> np.ndarray:
        return read_png(os.path.join(self.root, kind, f"{sample_id:05d}.png"))

    def _scoremaps(self, coords_hw: np.ndarray, vis: np.ndarray) -> np.ndarray:
        sig = self.sigma * np.sqrt(2)
        # Heatmapcreator.get takes (y, x)-ordered input (keypoints2d.py:28)
        d = coords_hw[:, :2, None, None] / sig - self._hm_grid[None]
        dist = np.einsum("jchw,jchw->jhw", d, d)
        maps = np.exp(-np.clip(dist, 0, 4.60517019)).astype(np.float32)
        maps[~vis.astype(bool)] = 0.0
        return maps

    def __getitem__(self, idx: int):
        cfg = self.cfg
        sid = self.ids[idx]
        anno = self.anno_all[sid]
        img = self._read("color", sid).astype(np.float32) / 255.0 - 0.5
        mask = self._read("mask", sid).astype(int)

        keypoint_uv = anno["uv_vis"][:, :2].astype(float)
        keypoint_vis = anno["uv_vis"][:, 2] == 1
        keypoint_xyz = np.asarray(anno["xyz"], dtype=np.float64)

        if not cfg.DATASETS.WRIST_COORD:
            keypoint_xyz = palm_coord(keypoint_xyz)
            keypoint_uv = palm_coord(keypoint_uv)
            palm_vis_l = keypoint_vis[0] | keypoint_vis[12]
            palm_vis_r = keypoint_vis[21] | keypoint_vis[33]
            keypoint_vis = np.hstack(
                [palm_vis_l, keypoint_vis[1:21], palm_vis_r, keypoint_vis[-20:]])

        if self.is_train:
            keypoint_uv = keypoint_uv + self.rng.normal(0, self.coord_uv_noise_sigma, (42, 2))

        # dominant hand by segmentation mask (RHD.py:92-107)
        num_left = ((mask > 1) & (mask < 18)).sum()
        num_right = (mask > 17).sum()
        hand = slice(0, 21) if num_left > num_right else slice(-21, None)
        cond_left, hand_side = (True, 0) if num_left > num_right else (False, 1)
        kp_xyz21, vis21, uv21 = keypoint_xyz[hand], keypoint_vis[hand], keypoint_uv[hand]

        rel = kp_xyz21 - kp_xyz21[0]
        keypoint_scale = np.linalg.norm(rel[12] - rel[11])
        normed = rel / keypoint_scale
        canonical, rot_mat = canonical_trafo(normed)
        if not cond_left and cfg.LIFTING.FLIP_ON:
            canonical = flip_hand(canonical)

        # hand crop (RHD.py:139-212)
        crop_center = uv21[12, ::-1].copy()
        if not np.isfinite(crop_center).all():
            crop_center = np.array([0.0, 0.0])
        if self.is_train:
            crop_center = crop_center + self.rng.normal(0, self.crop_center_noise_sigma, 2)
        kp_hw = uv21 * vis21[:, None]
        min_c = np.maximum(kp_hw.min(0), 0.0)
        max_c = np.minimum(kp_hw.max(0), self.image_size)
        crop_size_best = float(np.max(2 * np.maximum(max_c - crop_center, crop_center - min_c)))
        crop_size_best = min(max(crop_size_best, 50.0), 500.0)
        if not np.isfinite(crop_size_best):
            crop_size_best = 200.0
        scale = float(self.crop_size) / crop_size_best
        scale = min(max(scale, 1.0), 10.0)

        cc = np.clip(crop_center, 0, self.image_size - 1)
        half = crop_size_best / 2
        y0, x0 = int(cc[0] - half), int(cc[1] - half)
        y1, x1 = int(cc[0] + half), int(cc[1] + half)
        y0c, x0c = max(y0, 0), max(x0, 0)
        y1c, x1c = min(y1, self.image_size - 1), min(x1, self.image_size - 1)
        cropped = img[y0c:y1c, x0c:x1c]
        if cropped.size == 0:
            cropped = img
        cropped = resize_bilinear(cropped, (self.crop_size, self.crop_size))

        if self.is_train:
            crop_center = crop_center + self.rng.normal(0, self.crop_offset_noise_sigma, 2)

        u = (uv21[:, 0] - crop_center[1]) * scale + self.crop_size // 2
        v = (uv21[:, 1] - crop_center[0]) * scale + self.crop_size // 2
        uv21 = np.stack([u, v], axis=1)

        scoremap = self._scoremaps(np.stack([uv21[:, 1], uv21[:, 0]], 1), vis21)

        return {
            "heatmap": scoremap.transpose(1, 2, 0).astype(np.float32),
            "hand-side": np.int32(hand_side),
            "img": cropped.astype(np.float32),
            "can-points-3d": canonical.astype(np.float32),
            "rotation": rot_mat.astype(np.float32),
            "scale": np.float32(keypoint_scale),
            "visibility": vis21.astype(np.float32),
            "normed-points-3d": normed.astype(np.float32),
            "unit": np.float32(self.unit),
        }
