"""H36M 17-joint skeleton tree (reference modeling/layers/body.py:9-64).

The port's own copy of epipolar_transformers_tpu/geometry/body.py.
"""

from __future__ import annotations

import numpy as np

JOINT_NAMES = [
    "root", "rhip", "rkne", "rank", "lhip", "lkne", "lank", "belly",
    "neck", "nose", "head", "lsho", "lelb", "lwri", "rsho", "relb", "rwri",
]
CHILDREN = [[1, 4, 7], [2], [3], [], [5], [6], [], [8], [9, 11, 14],
            [10], [], [12], [13], [], [15], [16], []]


class HumanBody:
    def __init__(self):
        self.skeleton = [
            {"idx": i, "name": JOINT_NAMES[i], "children": CHILDREN[i]}
            for i in range(len(JOINT_NAMES))
        ]
        self.skeleton_sorted_by_level = self._sort_by_level(self.skeleton)

    @staticmethod
    def _sort_by_level(skeleton):
        njoints = len(skeleton)
        level = np.zeros(njoints)
        queue = [skeleton[0]]
        while queue:
            cur = queue.pop(0)
            for child in cur["children"]:
                skeleton[child]["parent"] = cur["idx"]
                level[child] = level[cur["idx"]] + 1
                queue.append(skeleton[child])
        order = np.argsort(level)[::-1]  # leaves first
        out = []
        for i in order:
            skeleton[i]["level"] = level[i]
            out.append(skeleton[i])
        return out


def compute_limb_length(body: HumanBody, pose: np.ndarray) -> dict:
    """reference body.py:9-19."""
    limb_length = {}
    for node in body.skeleton:
        for child in node["children"]:
            limb_length[(node["idx"], child)] = float(
                np.linalg.norm(pose[node["idx"]] - pose[child])
            )
    return limb_length
