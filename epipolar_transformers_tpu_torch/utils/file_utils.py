"""Text camera files for custom rigs, and prediction-pickle naming.

The port's own copy of epipolar_transformers_tpu/utils/file_utils.py
(reference utils/file_utils.py:22-49).  The KRT text format: blocks of
    <camera name>
    K row x3
    R|T rows x3 (3x4)
separated by blank lines (the reference's Panoptic-style dome files).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def load_krt(path: str) -> Dict[str, dict]:
    """Parse a KRT text file -> {name: {'K': 3x3, 'RT': 3x4, 'KRT': 3x4}}."""
    cameras = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        name = lines[i]
        K = np.array([[float(v) for v in lines[i + 1 + r].split()] for r in range(3)])
        RT = np.array([[float(v) for v in lines[i + 4 + r].split()] for r in range(3)])
        cameras[name] = {"K": K, "RT": RT, "KRT": K @ RT}
        i += 7
    return cameras


def save_krt(path: str, cameras: Dict[str, dict]) -> None:
    with open(path, "w") as f:
        for name, cam in cameras.items():
            f.write(name + "\n")
            for row in np.asarray(cam["K"]):
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
            for row in np.asarray(cam["RT"]):
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")
            f.write("\n")


def pred_pickle_path(cfg, out_dir: str | None = None) -> str:
    """Canonical saved-predictions pickle path.

    One derivation for the writer (engine/tester SAVE_PRED) and every
    reader.  The reference names the dump via VIS.SAVE_PRED_NAME with torch's
    .pth suffix (tester.py:216-227); the dump is a pickle, hence the suffix
    rewrite.
    """
    name = cfg.VIS.SAVE_PRED_NAME.replace(".pth", ".pkl").replace(".npz", ".pkl")
    return os.path.join(out_dir if out_dir is not None else (cfg.OUTPUT_DIR or "."), name)
