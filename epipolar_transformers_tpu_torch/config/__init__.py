"""Configuration: the port's config tree, loader and catalogs, and the flagship.

`schema`, `loader` and `catalog` are the port's own copies of the JAX
package's config modules (frozen dataclasses, numpy-free), so that one YAML
tree drives both packages without the port importing the other.
`flagship_cfg` is the configuration of `__graft_entry__._flagship_cfg`
(tests/test_torch_slice.py holds the two equal, field by field).
"""

from __future__ import annotations

from .catalog import BackboneCatalog, DatasetCatalog
from .loader import load_config
from .schema import Config, update_from_dict

__all__ = ["Config", "load_config", "update_from_dict", "flagship_cfg",
           "BackboneCatalog", "DatasetCatalog"]


def flagship_cfg(tiny: bool = False) -> Config:
    """The flagship multiview config: epipolarposeR-50, 256 px, 64x64
    heatmaps, 17 joints, K=64, avg/dot attention, late merge, shared weights,
    z + zero-init BN + residual, bf16 convolutions.  `tiny` is its test
    proxy: R-18, 32 px, 8x8 heatmaps, 5 joints, K=4, f32."""
    if tiny:
        size, heatmap, joints, sigma, body, k = (32, 32), (8, 8), 5, 2.0, "epipolarposeR-18", 4
    else:
        size, heatmap, joints, sigma, body, k = (256, 256), (64, 64), 17, 8.0, "epipolarposeR-50", 64
    d = {
        "DATASETS": {
            "TRAIN": ("synthetic_multiview_train",),
            "TEST": ("synthetic_multiview_val",),
            "TASK": "multiview_keypoint",
            "IMAGE_SIZE": size,
            "IMAGE_RESIZE": 1.0,
            "PREDICT_RESIZE": 1.0,
        },
        "BACKBONE": {"ENABLED": True, "BODY": body, "PRETRAINED": False, "DOWNSAMPLE": 4},
        "KEYPOINT": {"ENABLED": True, "NUM_PTS": joints, "HEATMAP_SIZE": heatmap,
                     "SIGMA": sigma, "NFEATS": 256, "LOSS": "joint",
                     "LOSS_PER_JOINT": False},
        "EPIPOLAR": {"SAMPLESIZE": k, "MERGE": "late", "ATTENTION": "avg",
                     "SIMILARITY": "dot", "PARAMETERIZED": ("z",),
                     "ZRESIDUAL": True, "SHARE_WEIGHTS": True,
                     "PRETRAINED": False, "USE_CORRECT_NORMALIZE": True},
        "SOLVER": {"OPTIMIZER": "adam", "BASE_LR": 1e-3},
    }
    if not tiny:
        d["KEYPOINT"]["TRIANGULATION"] = "pymvg"
        d["DTYPE"] = "bfloat16"
    return update_from_dict(Config(), d)
