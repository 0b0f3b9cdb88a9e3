"""MPII 2D pose dataset and its multiview and mixed variants.

Port of epipolar_transformers_tpu/data/datasets/mpii.py (reference
data/datasets/mpii.py:19-87, multiview_mpii.py, mixed_dataset.py:19-56),
on the port's JointsDataset: the JSON annotations (MATLAB 1-based centres
and joints, the limb-cropping centre shift and 1.25 scale), the 16 MPII
joints mapped into the 20-joint union, an identity camera per record.
MPII records carry no real camera, so the multiview variant groups
consecutive quadruples of records, as the reference's MixedDataset does;
it serves only to pretrain the 2D heatmap head.  Items equal the JAX
package's (tests/test_torch_h36m.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ...config import Config
from .joints_dataset import JointsDataset


class MPIIDataset(JointsDataset):
    actual_joints = {
        0: "rank", 1: "rkne", 2: "rhip", 3: "lhip", 4: "lkne", 5: "lank",
        6: "root", 7: "thorax", 8: "upper neck", 9: "head top", 10: "rwri",
        11: "relb", 12: "rsho", 13: "lsho", 14: "lelb", 15: "lwri",
    }

    def __init__(self, cfg: Config, root: str, subset: str, is_train: bool, seed: int = 0):
        super().__init__(cfg, root, is_train, seed)
        self.subset = subset
        self.db = self._get_db()
        self.u2a_mapping = self.get_mapping()
        self.do_mapping()

    def _get_db(self):
        with open(os.path.join(self.root, "mpii", "annot", f"{self.subset}.json")) as f:
            anno = json.load(f)
        identity = {"R": np.eye(3), "T": np.zeros((3, 1)), "fx": 1.0, "fy": 1.0,
                    "cx": 0.0, "cy": 0.0, "k": np.zeros((3, 1)), "p": np.zeros((2, 1))}
        db = []
        for i, a in enumerate(anno):
            c = np.array(a["center"], dtype=np.float64)
            s = np.array([a["scale"], a["scale"]], dtype=np.float64)
            if c[0] != -1:
                # avoid cropping limbs (reference mpii.py:59-61)
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # matlab 1-based
            joints = np.array(a.get("joints", np.zeros((16, 2))), dtype=np.float64)
            joints[:, :2] = joints[:, :2] - 1
            joints_vis = np.zeros((16, 3))
            if self.subset != "test" and "joints_vis" in a:
                v = np.array(a["joints_vis"], dtype=np.float64)
                joints_vis[:, 0] = v
                joints_vis[:, 1] = v
            db.append({
                "image": a["image"], "center": c, "scale": s,
                "joints_2d": joints, "joints_3d": np.zeros((len(joints), 3)),
                "joints_3d_camera": np.full((len(joints), 3), 1.0),
                "joints_vis": joints_vis, "source": "mpii",
                "subject": 0, "action": 0, "subaction": 0, "image_id": i,
                "camera_id": i % 4, "camera": identity,
            })
        return db


class MultiviewMPIIDataset(MPIIDataset):
    """4-image pseudo-groups over consecutive MPII records
    (reference multiview_mpii.py / mixed_dataset.py:47-56)."""

    def __init__(self, cfg: Config, root: str, subset: str, is_train: bool, seed: int = 0):
        super().__init__(cfg, root, subset, is_train, seed)
        self.grouping = [[i * 4 + j for j in range(4)] for i in range(len(self.db) // 4)]

    def __len__(self):
        return len(self.grouping)

    def __getitem__(self, idx: int):
        data = [JointsDataset.__getitem__(self, i) for i in self.grouping[idx]]
        return {k: np.stack([d[k] for d in data]) for k in data[0]}


class MixedDataset:
    """H36M groups followed by MPII pseudo-groups
    (reference mixed_dataset.py:19-56)."""

    def __init__(self, h36m, mpii_multiview):
        self.h36m = h36m
        self.mpii = mpii_multiview
        self.io_bound = any(getattr(d, "io_bound", False) for d in (h36m, mpii_multiview))

    def reseed(self, seed) -> None:
        """A loader worker's own streams, one per part."""
        for i, d in enumerate((self.h36m, self.mpii)):
            d.reseed([*np.atleast_1d(seed), i])

    def __len__(self):
        return len(self.h36m) + len(self.mpii)

    def __getitem__(self, idx: int):
        if idx < len(self.h36m):
            return self.h36m[idx]
        return self.mpii[idx - len(self.h36m)]
