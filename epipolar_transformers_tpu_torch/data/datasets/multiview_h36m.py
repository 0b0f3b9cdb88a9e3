"""Multi-view H36M: camera groups and TOPK-nearest view pairing.

Port of epipolar_transformers_tpu/data/datasets/multiview_h36m.py
(reference data/datasets/multiview_h36m.py:24-331): the records of the
annotation pickle grouped by (subject, action, subaction, image id) into
4-camera groups (TRAIN_SAMPLE / TEST_SAMPLE every n-th group,
FILTER_DAMAGE, MAPPING to the 20-joint union).  At train time an item is a
reference view drawn from the group and its TOPK-nearest other view; at
test time all views stacked, each with its nearest other view, optionally
NUM_CAM of them, and with REAL3D the 3D points retriangulated from the 2D
ones.  `evaluate` is the JDR at half the head size.  Items equal the JAX
package's (tests/test_torch_h36m.py).

The draws come from the dataset's own `rng` (joints_dataset.py): the four
views' augmentations first, then the reference camera.  Under
VIS.MULTIVIEWH36M each train item also writes its epipolar debug view
(vis/visualization.py:dump_epipolar_debug_pair).
"""

from __future__ import annotations

import pickle

import numpy as np

from ...config import Config
from ...geometry.camera import neighbor_cameras
from ...geometry.host import triangulate_pymvg_np
from .joints_dataset import ACTUAL_IN_UNION, JointsDataset

INDEX_TO_ACTION = {
    2: "Direction", 3: "Discuss", 4: "Eating", 5: "Greet", 6: "Phone",
    7: "Pose", 8: "Purchase", 9: "Sitting", 10: "SittingDown", 11: "Smoke",
    12: "Photo", 13: "Wait", 14: "WalkDog", 15: "Walk", 16: "WalkTo",
}


class MultiViewH36M(JointsDataset):
    actual_joints = {
        0: "root", 1: "rhip", 2: "rkne", 3: "rank", 4: "lhip", 5: "lkne",
        6: "lank", 7: "belly", 8: "neck", 9: "nose", 10: "head", 11: "lsho",
        12: "lelb", 13: "lwri", 14: "rsho", 15: "relb", 16: "rwri",
    }

    def __init__(self, cfg: Config, root: str, anno_file: str, is_train: bool, seed: int = 0):
        super().__init__(cfg, root, is_train, seed)
        with open(anno_file, "rb") as f:
            self.db = pickle.load(f)
        if cfg.DATASETS.H36M.FILTER_DAMAGE:
            self.db = [r for r in self.db if not self.isdamaged(r)]
        if cfg.DATASETS.H36M.MAPPING:
            if cfg.KEYPOINT.NUM_PTS != 20:
                raise ValueError(f"DATASETS.H36M.MAPPING needs KEYPOINT.NUM_PTS 20, not "
                                 f"{cfg.KEYPOINT.NUM_PTS}")
            self.u2a_mapping = self.get_mapping()
            self.do_mapping()
        elif cfg.KEYPOINT.NUM_PTS != 17:
            raise ValueError(f"H36M without MAPPING has 17 joints, not KEYPOINT.NUM_PTS "
                             f"{cfg.KEYPOINT.NUM_PTS}")
        self.grouping = self._get_group()

    @staticmethod
    def index_to_action_names():
        return INDEX_TO_ACTION

    def _get_group(self):
        grouping = {}
        for i, rec in enumerate(self.db):
            grouping.setdefault(self.get_key_str(rec), [-1, -1, -1, -1])[rec["camera_id"]] = i
        filtered = [v for v in grouping.values() if all(x != -1 for x in v)]
        sample = (self.cfg.DATASETS.H36M.TRAIN_SAMPLE if self.is_train
                  else self.cfg.DATASETS.H36M.TEST_SAMPLE)
        if sample:
            filtered = filtered[::sample]
        return filtered

    def __len__(self):
        return len(self.grouping)

    def __getitem__(self, idx: int):
        cfg = self.cfg
        items = list(self.grouping[idx])
        data = {cam: JointsDataset.__getitem__(self, item) for cam, item in enumerate(items)}
        rank = neighbor_cameras({cam: d["KRT"] for cam, d in data.items()})

        if self.is_train:
            # TOPK view pairing (multiview_h36m.py:132-145)
            topk = cfg.EPIPOLAR.TOPK
            if topk == 3:
                ref_cam, other_cam = self.rng.choice(len(items), 2, replace=False)
            elif topk == 2:
                ref_cam = self.rng.randint(len(items))
                other_cam = int(self.rng.choice(rank[ref_cam][0][:2]))
            elif topk == 1:
                ref_cam = self.rng.randint(len(items))
                other_cam = rank[ref_cam][0][0]
            else:
                raise NotImplementedError(f"EPIPOLAR.TOPK {topk}")
            ret = dict(data[ref_cam])
            other = data[other_cam]
            ret["camera"] = np.int32(ref_cam)
            ret["other_camera"] = np.int32(other_cam)
            for k in ("img", "KRT", "heatmap"):
                if k in other:
                    ret["other_" + k] = other[k]
            if cfg.VIS.MULTIVIEWH36M:
                # the reference's in-dataset epipolar debug view,
                # headless (multiview_h36m.py:159-243)
                from ...vis.visualization import dump_epipolar_debug_pair

                dump_epipolar_debug_pair(cfg, ret, idx)
            return ret

        # test: all views stacked + nearest other per view
        ret = {"camera": []}
        for k in data[0]:
            ret[k] = []
        for k in ("img", "KRT", "heatmap", "camera"):
            ret["other_" + k] = []
        for ref_cam, datum in data.items():
            ret["camera"].append(np.int32(ref_cam))
            other_cam = rank[ref_cam][0][0]
            ret["other_camera"].append(np.int32(other_cam))
            for k, v in datum.items():
                ret[k].append(v)
            for k in ("img", "KRT", "heatmap"):
                if k in data[other_cam]:
                    ret["other_" + k].append(data[other_cam][k])
        if cfg.KEYPOINT.NUM_CAM:
            ret = {k: v[:cfg.KEYPOINT.NUM_CAM] for k, v in ret.items()}
        ret = {k: np.stack(v) for k, v in ret.items() if len(v)}
        if cfg.DATASETS.H36M.REAL3D:
            real3d = self.compute_real3d(ret["points-2d"], ret["K"], ret["RT"])
            ret["points-3d"] = np.broadcast_to(real3d, ret["points-3d"].shape).copy()
        return ret

    def compute_real3d(self, pts, Ks, RTs):
        """Retriangulate the ground-truth 3D from the 2D points
        (multiview_h36m.py:297-305)."""
        if self.cfg.DATASETS.H36M.MAPPING:
            pts = pts[:, ACTUAL_IN_UNION]
        confs = np.ones((pts.shape[0], pts.shape[1]))
        return triangulate_pymvg_np(pts.astype(np.float64), Ks, RTs, confs)

    def evaluate(self, pred):
        """2D JDR at headsize/2 (multiview_h36m.py:264-295): (per-joint
        rates by name, their mean)."""
        headsize = self.image_size[0] / 10.0
        threshold = 0.5
        u2a = self.u2a_mapping or {i: i for i in range(self.num_joints)}
        a2u = {v: k for k, v in u2a.items() if v != "*"}
        a = list(a2u.keys())
        indexes = sorted(range(len(a)), key=a.__getitem__)
        sa = [a[i] for i in indexes]
        su = np.array([a2u[k] for k in sa])

        gt = np.array([self.db[item]["joints_2d"][su, :2]
                       for items in self.grouping for item in items])
        pred = np.asarray(pred)[:, su, :2]
        distance = np.sqrt(np.sum((gt - pred) ** 2, axis=2))
        detected = distance <= headsize * threshold
        jdr = detected.sum(axis=0) / float(gt.shape[0])
        name_values = {self.actual_joints[sa[i]]: jdr[i] for i in range(len(a2u))}
        return name_values, float(np.mean(jdr))


class H36MDataset(MultiViewH36M):
    """Single-view variant: one random view of a group at train time, view
    idx % 4 at test time (reference data/datasets/h36m.py:96-116)."""

    def __getitem__(self, idx: int):
        items = list(self.grouping[idx])
        if self.is_train:
            cam = self.rng.randint(len(items))
            return JointsDataset.__getitem__(self, items[cam])
        return JointsDataset.__getitem__(self, items[idx % len(items)])
