"""Prediction-pickle naming.

The port's own copy of `pred_pickle_path` from
epipolar_transformers_tpu/utils/file_utils.py; the KRT text parser there is
ROADMAP A13 in the port.
"""

from __future__ import annotations

import os


def pred_pickle_path(cfg, out_dir: str | None = None) -> str:
    """Canonical saved-predictions pickle path.

    One derivation for the writer (engine/tester SAVE_PRED) and every
    reader.  The reference names the dump via VIS.SAVE_PRED_NAME with torch's
    .pth suffix (tester.py:216-227); the dump is a pickle, hence the suffix
    rewrite.
    """
    name = cfg.VIS.SAVE_PRED_NAME.replace(".pth", ".pkl").replace(".npz", ".pkl")
    return os.path.join(out_dir if out_dir is not None else (cfg.OUTPUT_DIR or "."), name)
