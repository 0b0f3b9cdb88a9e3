"""Frozen configuration tree of the port.

The port's own copy of epipolar_transformers_tpu/config/schema.py: the
same groups, fields and defaults (tests/test_torch_config.py holds the two
default trees equal), so that the reference's YAML configs load unchanged
(`config.loader`).  The tree is frozen dataclasses passed explicitly to
constructors rather than a global mutable singleton (reference
core/config.py:5-292).  Fields that only the JAX package reads (the TPU
mesh, remat, loader start methods) are kept so one YAML drives both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Tuple


def _freeze(value: Any) -> Any:
    """Recursively convert lists to tuples so the tree stays hashable."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, tuple):
        return tuple(_freeze(v) for v in value)
    return value


class _Node:
    """Shared helpers for config nodes."""

    def replace(self, **kwargs):
        return dataclasses.replace(self, **{k: _freeze(v) for k, v in kwargs.items()})

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, _Node) else v
        return out


@dataclass(frozen=True)
class BackboneConfig(_Node):
    """reference: core/config.py:16-25"""

    ENABLED: bool = False
    # ResNets: R-18,34,50,101,152 / HG, HG1, HG11 / pose+epipolar variants
    BODY: str = "R-50"
    PRETRAINED: bool = True
    PRETRAINED_WEIGHTS: str = ""
    DOWNSAMPLE: int = 4
    BN_MOMENTUM: float = 0.1
    SYNC_BN: bool = False
    # Mapped-axis name for explicit BN moment sync ('' = GSPMD-implicit under
    # jit, the trainer's mode). Required when training under shard_map/pmap:
    # GuardedBatchNorm (models/layers.py) raises if batch statistics would be
    # computed per-shard under a named axis without it.
    BN_AXIS_NAME: str = ""


@dataclass(frozen=True)
class LiftingConfig(_Node):
    """reference: core/config.py:30-42"""

    ENABLED: bool = False
    VIEW_ON: bool = False
    FLIP_ON: bool = False
    CROP_SIZE: int = 256
    IMAGE_SIZE: int = 320
    AVELOSS_KP: bool = False
    MULTIVIEW_UPPERBOUND: bool = False
    MULTIVIEW_MEDIUM: bool = True


@dataclass(frozen=True)
class KeypointConfig(_Node):
    """reference: core/config.py:47-63"""

    ENABLED: bool = False
    SIGMA: float = 25.0
    NUM_PTS: int = 21
    ROOTIDX: int = 0
    HEATMAP_SIZE: Tuple[int, int] = (224, 224)
    NUM_CAM: int = 0
    NFEATS: int = 256
    # naive, pymvg, refine, epipolar, epipolar_dlt, rpsm
    TRIANGULATION: str = "naive"
    CONF_THRES: float = 0.05
    RANSAC_THRES: float = 3.0
    # mse, joint, smoothmse
    LOSS: str = "mse"
    LOSS_PER_JOINT: bool = True


@dataclass(frozen=True)
class EpipolarConfig(_Node):
    """reference: core/config.py:69-118"""

    VIS: bool = False
    TOPK: int = 1
    TOPK_RANGE: Tuple[int, int] = (1, 2)
    # max: select most similar sample; avg: similarity-weighted average
    ATTENTION: str = "max"
    # cos, dot, prior
    SIMILARITY: str = "dot"
    # attention schedule (framework-native; no reference counterpart):
    # auto | matmul | pooled | streaming | reference — see
    # models/epipolar.py Epipolar.impl.  'auto' picks the fastest valid
    # path for the config's semantics; forcing one is a debug/bench tool.
    ATTENTION_IMPL: str = "auto"
    # training-time rematerialization of the matmul attention chunks
    # (framework-native knob, no reference counterpart):
    # full | dots | dots_bf16 | none.
    # 'full' recomputes the whole chunk in the backward (lowest memory);
    # 'dots' saves the einsum outputs and recomputes only the elementwise
    # middle (jax dots_saveable policy); 'dots_bf16' is 'dots' with the
    # big saved residuals bf16-rounded (halves the remat HBM traffic;
    # perturbs training activations by bf16 rounding ~0.4%); 'none' saves
    # everything.  Measured on the v5e flagship shape in PERF.md
    # (bench_bwd_stages.py).
    ATTENTION_REMAT: str = "full"
    SAMPLESIZE: int = 64
    SOFTMAX_ENABLED: bool = True
    SOFTMAXBETA: bool = True
    # merge features early / late / both
    MERGE: str = "early"
    OTHER_ONLY: bool = False
    OTHER_GRAD: Tuple[str, ...] = ("other1", "other2")
    SHARE_WEIGHTS: bool = False
    # subset of {'z', 'theta', 'phi', 'g'}
    PARAMETERIZED: Tuple[str, ...] = ()
    ZRESIDUAL: bool = False
    MULTITEST: bool = False
    WARPEDHEATMAP: bool = False
    PRIOR: bool = False
    PRIORMUL: bool = False
    REPROJECT_LOSS_WEIGHT: float = 0.0
    SIM_LOSS_WEIGHT: float = 0.0
    PRETRAINED: bool = True
    # find correspondence based on 'feature' or 'rgb'
    FIND_CORR: str = "feature"
    BOTTLENECK: int = 1
    POOLING: bool = False
    USE_CORRECT_NORMALIZE: bool = False

    @property
    def SOFTMAXSCALE(self) -> float:
        # attention scale 1/sqrt(K) (reference: core/config.py:86)
        return 1.0 / self.SAMPLESIZE ** 0.5


@dataclass(frozen=True)
class PictStructConfig(_Node):
    """reference: core/config.py:123-134"""

    FIRST_NBINS: int = 16
    PAIRWISE_FILE: str = "datasets/h36m/pairwise.pkl"
    RECUR_NBINS: int = 2
    RECUR_DEPTH: int = 10
    LIMB_LENGTH_TOLERANCE: float = 150.0
    GRID_SIZE: float = 2000.0
    DEBUG: bool = False
    TEST_PAIRWISE: bool = False
    SHOW_ORIIMG: bool = False
    SHOW_CROPIMG: bool = False
    SHOW_HEATIMG: bool = False


@dataclass(frozen=True)
class H36MConfig(_Node):
    """reference: core/config.py:182-192"""

    REAL3D: bool = True
    MAPPING: bool = True
    FILTER_DAMAGE: bool = True
    TRAIN_SAMPLE: int = 5
    TEST_SAMPLE: int = 64


@dataclass(frozen=True)
class DatasetsConfig(_Node):
    """reference: core/config.py:139-192"""

    TRAIN: Tuple[str, ...] = ()
    TEST: Tuple[str, ...] = ()
    COMPLETENESS: float = 1.0
    # lifting, lifting_rot, img_lifting_rot, lifting_direct, keypoint,
    # keypoint_lifting_rot, keypoint_lifting_direct, multiview_keypoint,
    # multiview_img_lifting_rot
    TASK: str = "lifting"
    WRIST_COORD: bool = False
    IMAGE_SIZE: Tuple[int, int] = (512, 336)  # (H, W)
    CROP_AFTER_RESIZE: bool = False
    CROP_SIZE: Tuple[int, int] = (512, 320)
    IMAGE_RESIZE: float = 2.0
    PREDICT_RESIZE: float = 4.0
    INCLUDE_GREY_IMGS: bool = True
    CAMERAS: Tuple[int, ...] = ()
    # jpg, zip, undistoredzip
    DATA_FORMAT: str = "jpg"
    ROT_FACTOR: float = 0.0
    SCALE_FACTOR: float = 0.0
    H36M: H36MConfig = field(default_factory=H36MConfig)


@dataclass(frozen=True)
class DataloaderConfig(_Node):
    """reference: core/config.py:196-200"""

    NUM_WORKERS: int = 20
    PIN_MEMORY: bool = True
    BENCHMARK: bool = False
    # Worker start method (no reference analog; torch hardcodes fork on
    # Linux).  'auto' (default) resolves to 'forkserver' when the parent
    # process is multi-threaded — a JAX parent always is, and forking it
    # can deadlock the child on a lock another parent thread held at fork
    # time — and to 'fork' for single-threaded parents.  Explicit 'fork'
    # (torch semantics: dataset inherited for free) is the opt-in for
    # dataset-inheritance speed; 'forkserver'/'spawn' start clean children
    # at the cost of pickling the dataset (all shipped datasets pickle).
    MP_START_METHOD: str = "auto"
    # TPU-native extension (no reference analog): synthetic-rig train items
    # carry only joint coords + cameras and the trainer splats img/heatmap
    # on-device (ops/synthetic_render.py) — shrinks the per-step host->
    # device upload from ~38 MB to ~KBs on tunnel-attached hosts.
    DEVICE_RENDER: bool = False


@dataclass(frozen=True)
class SolverConfig(_Node):
    """reference: core/config.py:205-229"""

    OPTIMIZER: str = "sgd"
    SCHEDULER: str = "multistep"
    FINETUNE: bool = False
    FINETUNE_FREEZE: bool = True
    MAX_EPOCHS: int = 40
    STEPS: Tuple[int, ...] = (20, 30)
    BASE_LR: float = 1e-3
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0
    GAMMA: float = 0.1
    CHECKPOINT_PERIOD: int = 2
    IMS_PER_BATCH: int = 8
    BATCH_MUL: int = 1


@dataclass(frozen=True)
class TestConfig(_Node):
    """reference: core/config.py:234-244"""

    IMS_PER_BATCH: int = 8
    THRESHOLDS: Tuple[float, ...] = (1, 2, 5, 10, 20, 30, 40, 50, 60, 80, 100)
    MAX_TH: float = 20.0
    PCK: bool = True
    EPEMEAN_MAX_DIST: float = 150.0
    RECOMPUTE_BN: bool = False
    TRAIN_BN: bool = False


@dataclass(frozen=True)
class TensorboardConfig(_Node):
    USE: bool = True
    COMMENT: str = ""


@dataclass(frozen=True)
class VisConfig(_Node):
    """reference: core/config.py:277-292"""

    DOVIS: bool = True
    SAVE_PRED: bool = False
    SAVE_PRED_NAME: str = "predictions.npz"
    SAVE_PRED_FREQ: int = 100
    SAVE_PRED_LIMIT: int = -1
    MULTIVIEW: bool = False
    POINTCLOUD: bool = False
    AUC: bool = False
    H36M: bool = False
    VIDEO: bool = False
    VIDEO_GT: bool = False
    MULTIVIEWH36M: bool = False
    EPIPOLAR_LINE: bool = False
    CURSOR: bool = False
    FLOPS: bool = False


@dataclass(frozen=True)
class Config(_Node):
    """Root config. Mirrors the reference's `_C` tree (core/config.py:5-292)."""

    BACKBONE: BackboneConfig = field(default_factory=BackboneConfig)
    LIFTING: LiftingConfig = field(default_factory=LiftingConfig)
    KEYPOINT: KeypointConfig = field(default_factory=KeypointConfig)
    EPIPOLAR: EpipolarConfig = field(default_factory=EpipolarConfig)
    PICT_STRUCT: PictStructConfig = field(default_factory=PictStructConfig)
    DATASETS: DatasetsConfig = field(default_factory=DatasetsConfig)
    DATALOADER: DataloaderConfig = field(default_factory=DataloaderConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    TENSORBOARD: TensorboardConfig = field(default_factory=TensorboardConfig)
    VIS: VisConfig = field(default_factory=VisConfig)

    SEED: int = 0
    OUTPUT_DIR: str = "outs"
    FOLDER_NAME: str = "outs/."
    WEIGHTS: str = ""
    WEIGHTS_PREFIX: str = "module."
    WEIGHTS_PREFIX_REPLACE: str = ""
    WEIGHTS_LOAD_OPT: bool = True
    WEIGHTS_ALLOW_DIFF_PREFIX: bool = False
    DEVICE: str = "tpu"
    LOG_FREQ: int = 100
    EVAL_FREQ: int = 4
    DOTRAIN: bool = True
    DOTEST: bool = True

    # Explicit dataset-family switch.  The reference selects H36M code paths by
    # substring-matching OUTPUT_DIR ('h36m' in cfg.OUTPUT_DIR, e.g.
    # modeling/model.py:75,252,264) — here it is a real field; the YAML loader
    # infers it from OUTPUT_DIR for compatibility with reference configs.
    DATASET_FAMILY: str = ""

    # TPU-specific additions (no reference equivalent).
    DTYPE: str = "float32"  # compute dtype for the backbone: float32|bfloat16
    MESH_AXIS: str = "data"
    # numerical sanitizers (the reference left torch detect_anomaly commented,
    # main.py:22; JAX exposes these as global debug flags)
    DEBUG_NANS: bool = False

    @property
    def is_h36m(self) -> bool:
        return self.DATASET_FAMILY == "h36m" or "h36m" in self.OUTPUT_DIR


def update_from_dict(node, d: Mapping[str, Any]):
    """Return a copy of `node` with (possibly nested) updates from dict `d`."""
    updates = {}
    for key, value in d.items():
        if not hasattr(node, key):
            raise KeyError(f"Unknown config key: {key!r} on {type(node).__name__}")
        current = getattr(node, key)
        if isinstance(current, _Node):
            if not isinstance(value, Mapping):
                raise TypeError(f"Expected mapping for config group {key!r}")
            updates[key] = update_from_dict(current, value)
        else:
            updates[key] = _freeze(value)
    return dataclasses.replace(node, **updates)
