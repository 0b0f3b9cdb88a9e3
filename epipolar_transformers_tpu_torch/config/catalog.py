"""Dataset and backbone catalogs.

The port's own copy of epipolar_transformers_tpu/config/catalog.py
(tests/test_torch_config.py holds the synthetic entries equal).  Equivalent of the reference's `core/paths_catalog.py` (DatasetCatalog maps
dataset names to factory + args, reference: core/paths_catalog.py:3-78;
BackboneCatalog maps backbone body names to the single-view pretrained
checkpoint used to initialize multiview models, reference:
core/paths_catalog.py:8-23).
"""

from __future__ import annotations

import os


class DatasetCatalog:
    DATA_DIR = "datasets"

    DATASETS = {
        # H36M multiview groups (reference: core/paths_catalog.py:28-43)
        "multiview_h36m_train": {
            "factory": "MultiViewH36M",
            "root": "",  # image path is <root>/<source>/images/<name>
            "anno": "h36m/annot/h36m_train.pkl",
            "is_train": True,
        },
        "multiview_h36m_val": {
            "factory": "MultiViewH36M",
            "root": "",  # image path is <root>/<source>/images/<name>
            "anno": "h36m/annot/h36m_validation.pkl",
            "is_train": False,
        },
        "h36m_train": {
            "factory": "H36MDataset",
            "root": "",  # image path is <root>/<source>/images/<name>
            "anno": "h36m/annot/h36m_train.pkl",
            "is_train": True,
        },
        "h36m_val": {
            "factory": "H36MDataset",
            "root": "",  # image path is <root>/<source>/images/<name>
            "anno": "h36m/annot/h36m_validation.pkl",
            "is_train": False,
        },
        # RHD rendered-hand (reference: core/paths_catalog.py:44-53)
        "rhd_train": {
            "factory": "RHDDataset",
            "root": "RHD_published_v2",
            "set": "training",
            "is_train": True,
        },
        "rhd_val": {
            "factory": "RHDDataset",
            "root": "RHD_published_v2",
            "set": "evaluation",
            "is_train": False,
        },
        # MPII 2D pose + pseudo-multiview + H36M-mixed variants (reference
        # data/datasets/mpii.py, multiview_mpii.py, mixed_dataset.py)
        "mpii_train": {
            "factory": "MPIIDataset",
            "root": "",
            "set": "train",
            "is_train": True,
        },
        "mpii_val": {
            "factory": "MPIIDataset",
            "root": "",
            "set": "valid",
            "is_train": False,
        },
        "multiview_mpii_train": {
            "factory": "MultiviewMPIIDataset",
            "root": "",
            "set": "train",
            "is_train": True,
        },
        "mixed_h36m_mpii_train": {
            "factory": "MixedDataset",
            "h36m": "multiview_h36m_train",
            "mpii": "multiview_mpii_train",
            "is_train": True,
        },
        # Synthetic rigs for tests/benchmarks (no reference equivalent — the
        # licensed H36M images are not shipped; this rig exercises the same
        # code paths with analytically known geometry).
        "synthetic_multiview_train": {"factory": "SyntheticMultiview", "is_train": True},
        "synthetic_multiview_val": {"factory": "SyntheticMultiview", "is_train": False},
        # flagship-shape validation rig: more unique skeletons for training,
        # and a genuinely held-out eval set (different skeleton seed)
        "synthetic_flagship_train": {
            "factory": "SyntheticMultiview", "is_train": True, "n_samples": 512,
        },
        "synthetic_flagship_val": {
            "factory": "SyntheticMultiview", "is_train": False, "n_samples": 64,
            "seed": 104729,
        },
    }

    # the reference's YAMLs spell these with different case
    # (core/paths_catalog.py:40-45: 'RHD_train'/'RHD_val')
    ALIASES = {"RHD_train": "rhd_train", "RHD_val": "rhd_val"}

    @classmethod
    def get(cls, name: str) -> dict:
        name = cls.ALIASES.get(name, name)
        if name not in cls.DATASETS:
            raise KeyError(f"Unknown dataset: {name!r}")
        entry = dict(cls.DATASETS[name])
        for key in ("root", "anno"):
            if key in entry:
                entry[key] = os.path.join(cls.DATA_DIR, entry[key])
        return entry


class BackboneCatalog:
    """Maps a multiview backbone body to (single-view body, pretrained dir).

    reference: core/paths_catalog.py:8-23 — 'epipolarposeR-50' trains from the
    single-view 'poseR-50' checkpoint directory.
    """

    OUTS_DIR = "outs"

    @classmethod
    def get(cls, body: str) -> tuple[str, str]:
        single = body.replace("epipolarpose", "pose").replace("epipolar", "")
        if single.startswith("poseR-"):
            ckpt_dir = os.path.join(cls.OUTS_DIR, "benchmark", "keypoint_h36m")
        elif single.startswith("HG"):
            ckpt_dir = os.path.join(cls.OUTS_DIR, "benchmark", "keypoint_hg")
        else:
            ckpt_dir = os.path.join(cls.OUTS_DIR, "benchmark", single)
        return single, ckpt_dir
