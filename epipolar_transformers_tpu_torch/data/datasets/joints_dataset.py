"""H36M-style per-view items on the host, in numpy.

Port of epipolar_transformers_tpu/data/datasets/joints_dataset.py
(reference data/datasets/joints_dataset.py:29-429): read the frame (a JPEG
file or a zip member), crop it to 1000 rows, undistort it, compose the
crop: KRT = (trans K) [R | -R T], update the joints' visibility after the
crop, and render the Gaussian target heatmaps.  Items are NHWC numpy dicts,
key for key and dtype for dtype the JAX package's.

The frames are decoded by the port's `read_jpeg` and undistorted by its
`undistort_image` and `undistort_points`, each bit-equal to the cv2 call
the JAX dataset makes; the crop's warp and the heatmaps are the port's
copies of JAX runtime/loader.py's.  The train-time draws (scale, then the
rotation's coin, then the rotation when the coin is <= 0.6, per view) come
from `self.rng`, a `np.random.RandomState` the dataset owns, seeded from
`seed` (cfg.SEED from the loader) and reseeded per loader worker
(data/pipeline.py), where the JAX package draws from numpy's global
generator in the same order: a port dataset seeded as the JAX package's
global generator gives the JAX items.

The 20-joint union <-> 17-joint mapping (MPII-compatible heads,
joints_dataset.py:53-158) and the S9 damaged-sequence filter
(joints_dataset.py:174-184) are kept.  Under DATALOADER.BENCHMARK an item
times its stages (setup, read, undistort, warp, heatmap; JAX
joints_dataset.py:161-172,206-255) into utils/profiling.py's
DATALOADER_STAGES, which a loader worker ships back to its consumer
(data/pipeline.py).
"""

from __future__ import annotations

import os.path as osp
import time

import numpy as np

from ...config import Config
from ...geometry.undistort import undistort_image, undistort_points
from ...utils import zipreader
from ...utils.profiling import DATALOADER_STAGES
from ..jpeg import read_jpeg
from ..transforms.affine import IMAGENET_MEAN, IMAGENET_STD, affine_transform, get_affine_transform
from ..transforms.warp import render_heatmaps, warp_affine

UNION_JOINTS = {
    0: "root", 1: "rhip", 2: "rkne", 3: "rank", 4: "lhip", 5: "lkne",
    6: "lank", 7: "belly", 8: "thorax", 9: "neck", 10: "upper neck",
    11: "nose", 12: "head", 13: "head top", 14: "lsho", 15: "lelb",
    16: "lwri", 17: "rsho", 18: "relb", 19: "rwri",
}

# indices of the 17 actual joints inside the 20-joint union
# (reference modeling/model.py:269)
ACTUAL_IN_UNION = np.array([0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 12, 14, 15, 16, 17, 18, 19])

LIFTING_TASKS = ("lifting", "lifting_direct", "lifting_rot")


class JointsDataset:
    """Base class; subclasses fill self.db with H36M-style records."""

    # a JPEG decode and an undistortion per view: the loader gives it
    # DATALOADER.NUM_WORKERS worker processes
    io_bound = True

    actual_joints: dict = {}

    def __init__(self, cfg: Config, root: str, is_train: bool, seed: int = 0):
        self.cfg = cfg
        self.root = root
        self.is_train = is_train
        self.db: list = []
        self.num_joints = cfg.KEYPOINT.NUM_PTS
        self.image_size = cfg.DATASETS.IMAGE_SIZE  # (W, H) per reference usage
        self.heatmap_size = cfg.KEYPOINT.HEATMAP_SIZE
        self.sigma = cfg.KEYPOINT.SIGMA
        self.data_format = cfg.DATASETS.DATA_FORMAT
        self.scale_factor = cfg.DATASETS.SCALE_FACTOR
        self.rotation_factor = cfg.DATASETS.ROT_FACTOR
        self.u2a_mapping: dict = {}
        self.rng = np.random.RandomState(seed)

    def reseed(self, seed) -> None:
        """Draw from np.random.RandomState(seed) from now on (a loader
        worker's own stream)."""
        self.rng = np.random.RandomState(seed)

    # -------------------------------------------------- joint mapping
    def get_mapping(self):
        union_values = list(UNION_JOINTS.values())
        mapping = {k: "*" for k in UNION_JOINTS}
        for k, v in self.actual_joints.items():
            mapping[union_values.index(v)] = k
        return mapping

    def do_mapping(self):
        for item in self.db:
            joints = item["joints_2d"]
            joints_vis = item["joints_vis"]
            n = len(self.u2a_mapping)
            ju = np.zeros((n, 2))
            jv = np.zeros((n, 3))
            for i in range(n):
                if self.u2a_mapping[i] != "*":
                    idx = int(self.u2a_mapping[i])
                    ju[i] = joints[idx]
                    jv[i] = joints_vis[idx]
            item["joints_2d"] = ju
            item["joints_vis"] = jv

    # -------------------------------------------------- filters
    @staticmethod
    def isdamaged(db_rec) -> bool:
        """S9 'Greeting-2' / 'SittingDown-2' / 'Waiting-1' damage filter
        (reference joints_dataset.py:174-184)."""
        if db_rec["subject"] != 9:
            return False
        return (db_rec["action"], db_rec["subaction"]) in ((5, 2), (10, 2), (13, 1))

    @staticmethod
    def get_key_str(datum) -> str:
        return "s_{:02}_act_{:02}_subact_{:02}_imgid_{:06}".format(
            datum["subject"], datum["action"], datum["subaction"], datum["image_id"])

    def __len__(self):
        return len(self.db)

    # -------------------------------------------------- image IO
    def _read_image(self, db_rec) -> np.ndarray:
        if self.data_format == "undistoredzip":
            image_dir = "undistoredimages.zip@"
        elif self.data_format == "zip":
            image_dir = "images.zip@"
        else:
            image_dir = ""
        path = osp.join(self.root, db_rec["source"], image_dir, "images", db_rec["image"])
        img = zipreader.imread(path) if "zip" in self.data_format else read_jpeg(path)
        return img[:1000]  # crop 1002x1000 -> 1000x1000 (joints_dataset.py:218)

    # -------------------------------------------------- item
    def __getitem__(self, idx: int):
        cfg = self.cfg
        db_rec = self.db[idx]
        needs_image = cfg.DATASETS.TASK not in LIFTING_TASKS
        mark = _StageClock() if cfg.DATALOADER.BENCHMARK else _no_clock

        joints = db_rec["joints_2d"].copy()
        joints_3d_camera = db_rec["joints_3d_camera"].copy()
        joints_vis = db_rec["joints_vis"].copy()
        center = np.array(db_rec["center"], dtype=np.float64).copy()
        scale = np.array(db_rec["scale"], dtype=np.float64).copy()

        normed = joints_3d_camera - joints_3d_camera[0]
        keypoint_scale = np.linalg.norm(normed[8] - normed[0])
        # guard degenerate records (MPII has no real 3D; scale would be 0)
        normed = normed / max(keypoint_scale, 1e-8)

        camera = db_rec["camera"]
        R = np.asarray(camera["R"], dtype=np.float64)
        T = np.asarray(camera["T"], dtype=np.float64).reshape(3, 1)
        K = np.array([[float(camera["fx"]), 0, float(camera["cx"])],
                      [0, float(camera["fy"]), float(camera["cy"])],
                      [0, 0, 1.0]])
        kk = np.asarray(camera["k"], dtype=np.float64).reshape(-1)
        pp = np.asarray(camera["p"], dtype=np.float64).reshape(-1)
        dist = np.array([kk[0], kk[1], pp[0], pp[1], kk[2]])
        world3d = (R.T @ joints_3d_camera.T + T).T
        Rt = np.concatenate([R, (-R @ T)], axis=1)

        img = None
        if needs_image:
            mark("setup")
            img = self._read_image(db_rec)
            mark("read")
            if self.data_format != "undistoredzip":
                img = undistort_image(img, K, dist)
            mark("undistort")

        joints = undistort_points(joints[:, :2], K, dist)
        center = undistort_points(center[None], K, dist)[0]

        rotation = 0
        if self.is_train:
            sf, rf = self.scale_factor, self.rotation_factor
            scale = scale * np.clip(self.rng.randn() * sf + 1, 1 - sf, 1 + sf)
            rotation = (np.clip(self.rng.randn() * rf, -rf * 2, rf * 2)
                        if self.rng.random_sample() <= 0.6 else 0)

        trans = get_affine_transform(center, scale, rotation, self.image_size)
        cropK = np.concatenate([trans, [[0.0, 0.0, 1.0]]], axis=0) @ K
        KRT = cropK @ Rt

        if needs_image:
            img = warp_affine(img.astype(np.float32), trans,
                              (int(self.image_size[0]), int(self.image_size[1])))
            mark("warp")

        for i in range(self.num_joints):
            if joints_vis[i, 0] > 0.0:
                joints[i, :2] = affine_transform(joints[i, :2], trans)
                if (np.min(joints[i, :2]) < 0 or joints[i, 0] >= self.image_size[0]
                        or joints[i, 1] >= self.image_size[1]):
                    joints_vis[i, :] = 0

        target = render_heatmaps(joints, tuple(self.heatmap_size), self.sigma,
                                 cfg.BACKBONE.DOWNSAMPLE)
        mark("heatmap")

        ret = {
            "heatmap": target.transpose(1, 2, 0),  # (h, w, J) NHWC
            "visibility": joints_vis[:, 0].astype(np.float32),
            "KRT": KRT.astype(np.float32),
            "points-2d": joints.astype(np.float32),
            "points-3d": world3d,
            "camera-points-3d": joints_3d_camera,
            "normed-points-3d": normed.astype(np.float32),
            "scale": np.float32(keypoint_scale),
            "action": np.int32(db_rec["action"]),
            "K": cropK.astype(np.float32),
            "RT": Rt.astype(np.float32),
        }
        if needs_image:
            # BGR -> normalized float RGB NHWC (torchvision-compatible)
            rgb = img[..., ::-1] / 255.0
            ret["img"] = ((rgb - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        if cfg.KEYPOINT.TRIANGULATION == "rpsm" and not self.is_train:
            ret["origK"] = K.astype(np.float32)
            ret["crop_center"] = center.astype(np.float32)
            ret["crop_scale"] = np.asarray(scale, dtype=np.float32)
        return ret


class _StageClock:
    """`mark(stage)` adds the seconds since the last mark (or since the
    clock started) to DATALOADER_STAGES under `stage`."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        now = time.perf_counter()
        DATALOADER_STAGES.add(stage, now - self.t)
        self.t = now


def _no_clock(stage: str) -> None:
    return None
