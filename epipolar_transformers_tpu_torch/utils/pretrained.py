"""Pretrained and foreign weights into a freshly built model, in place.

Port of epipolar_transformers_tpu/utils/pretrained.py (reference
modeling/model.py:37-54, utils/checkpoint.py:49-70), in the same order
(`apply_pretrained`):
  * BACKBONE.PRETRAINED_WEIGHTS: a torch checkpoint into every trunk, without
    `final_layer` (reference resnet.py:511-517);
  * EPIPOLAR.PRETRAINED, or weights not shared: the BackboneCatalog
    single-view torch checkpoint under `backbone.module.` into `reference`,
    and into the sibling `backbone` when weights are not shared;
  * a foreign `.pth` in cfg.WEIGHTS, under WEIGHTS_PREFIX,
    WEIGHTS_PREFIX_REPLACE and WEIGHTS_ALLOW_DIFF_PREFIX;
  * the TF `.pickle`/`.pkl` weights of the lifting net in cfg.WEIGHTS
    (utils/ext_model_loading.py), under `liftingnet` for the lifting tasks
    (JAX utils/pretrained.py:190-200), aligned by suffix in flax-path space.

The port's own checkpoints also end in `.pth`; `Checkpointer.is_native`
tells them apart by content, and they go through the Checkpointer, whose
`last_checkpoint` tag wins over all of this.  A JAX `.ckpt` (flax msgpack,
utils/flax_msgpack.py) in cfg.WEIGHTS goes through the Checkpointer too,
as in the JAX package; a BackboneCatalog directory's `model_final.ckpt` is
grafted here, its `backbone` subtree by suffix onto each target (JAX
`_graft_subtree`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..config import BackboneCatalog, Config
from .checkpoint import Checkpointer
from .ext_model_loading import load_external_weights
from .flax_msgpack import read_checkpoint
from .torch_import import (import_flax_leaves, load_into_model, load_torch_state_dict,
                           read_torch_file)

logger = logging.getLogger(__name__)


def resolve_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of a single-view output dir: the `last_checkpoint`
    tag wins (reference checkpoint.py:54-57,77-96), then the conventional
    names."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    tag = os.path.join(ckpt_dir, "last_checkpoint")
    if os.path.exists(tag):
        with open(tag) as f:
            name = f.read().strip()
        # the reference stores absolute paths in the tag; tolerate both
        path = name if os.path.isabs(name) else os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            return path
    for name in ("model_final.ckpt", "model.pth", "model_final.pth"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            return path
    return None


def load_single_view_pretrained(cfg: Config, model: torch.nn.Module) -> None:
    """EPIPOLAR.PRETRAINED / not SHARE_WEIGHTS: the BackboneCatalog
    single-view checkpoint into the multiview model's backbones (reference
    modeling/model.py:35-54)."""
    if cfg.DATASETS.TASK != "multiview_keypoint":
        return
    if not (cfg.EPIPOLAR.PRETRAINED or not cfg.EPIPOLAR.SHARE_WEIGHTS):
        return
    _, ckpt_dir = BackboneCatalog.get(cfg.BACKBONE.BODY)
    path = resolve_checkpoint(ckpt_dir)
    if path is None:
        logger.info("pretrained: no single-view checkpoint under %s", ckpt_dir)
        return
    targets = (["reference"] if cfg.EPIPOLAR.PRETRAINED else []) + \
        (["backbone"] if not cfg.EPIPOLAR.SHARE_WEIGHTS else [])
    if path.endswith(".ckpt"):
        params, stats, _ = read_checkpoint(path)
        for sub in targets:
            graft_subtree(model, params, stats, "backbone", sub)
        return
    # keys carry the DataParallel wrapper prefix 'backbone.module.'
    # (reference model.py:42,53)
    sd = load_torch_state_dict(path)
    for sub in targets:
        missing = load_into_model(model, sd, prefix="backbone.module.", submodule=sub)
        logger.info("pretrained: torch import into %s (%d leaves kept init)", sub, len(missing))


def _flatten(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def graft_subtree(model: torch.nn.Module, params: dict, stats: dict, src_root: str,
                  dst_root: str) -> None:
    """A flax checkpoint's `src_root` subtree (e.g. the single-view
    'backbone') onto the model's `dst_root` submodule (e.g. 'reference'),
    leaf by leaf aligned by suffix (JAX utils/pretrained.py:_graft_subtree,
    reference `load(prefix='backbone.module.')`, modeling/model.py:41-54)."""
    flat = [_flatten(src.get(src_root, src), dst_root) if src else {}
            for src in (params, stats)]
    missing = import_flax_leaves(model, *flat)
    logger.info("pretrained: grafted %s -> %s (%d parameter leaves kept init)", src_root,
                dst_root, len(missing))


def load_backbone_pretrained(cfg: Config, model: torch.nn.Module) -> None:
    """BACKBONE.PRETRAINED + BACKBONE.PRETRAINED_WEIGHTS: a torch checkpoint
    into every trunk the builder made, `final_layer` excluded (reference
    resnet.py:511-517 -> init_weights:439-471)."""
    if not (cfg.BACKBONE.PRETRAINED and cfg.BACKBONE.PRETRAINED_WEIGHTS):
        return
    path = cfg.BACKBONE.PRETRAINED_WEIGHTS
    if not os.path.exists(path):
        logger.warning("BACKBONE.PRETRAINED_WEIGHTS=%r does not exist: the backbone keeps "
                       "its initial weights", path)
        return
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if not k.split("module.")[-1].startswith("final_layer.")}
    for sub in ("backbone", "reference"):
        if isinstance(getattr(model, sub, None), torch.nn.Module):
            missing = load_into_model(
                model, sd, prefix=cfg.WEIGHTS_PREFIX, prefix_replace=cfg.WEIGHTS_PREFIX_REPLACE,
                submodule=sub, allow_diff_prefix=cfg.WEIGHTS_ALLOW_DIFF_PREFIX)
            logger.info("BACKBONE.PRETRAINED_WEIGHTS: imported into %s (%d leaves kept init)",
                        sub, len(missing))


def load_external(cfg: Config, model: torch.nn.Module, path: str) -> None:
    """The TF-pickle lifting weights into `model` (JAX utils/pretrained.py:
    190-200): under `liftingnet` for a lifting task, aligned by suffix."""
    src = load_external_weights(cfg.DATASETS.TASK, path)
    if "lifting" in cfg.DATASETS.TASK:
        src = {f"liftingnet/{k}": v for k, v in src.items()}
    missing = import_flax_leaves(model, src, {})
    logger.info("Imported external weights from %s (%d leaves kept init)", path, len(missing))


def load_cfg_weights(cfg: Config, model: torch.nn.Module) -> bool:
    """Import cfg.WEIGHTS when it is a foreign torch file or TF pickle;
    returns whether it did.  The port's own checkpoints and JAX `.ckpt`
    files are left to the Checkpointer."""
    path = cfg.WEIGHTS
    if not path or path.endswith(".ckpt"):
        # a JAX .ckpt is the Checkpointer's, as a native one is in JAX
        return False
    if not os.path.exists(path):
        logger.warning("cfg.WEIGHTS=%r does not exist: proceeding from the initial weights",
                       path)
        return False
    ext = os.path.splitext(path)[1]
    if ext in (".pickle", ".pkl"):
        load_external(cfg, model, path)
        return True
    if ext != ".pth":
        logger.warning("cfg.WEIGHTS=%r has an unrecognized extension (expect .pth or "
                       ".pickle): nothing loaded", path)
        return False
    payload = read_torch_file(path)
    if Checkpointer.is_native(payload):
        return False
    missing = load_into_model(
        model, load_torch_state_dict(payload), prefix=cfg.WEIGHTS_PREFIX,
        prefix_replace=cfg.WEIGHTS_PREFIX_REPLACE,
        allow_diff_prefix=cfg.WEIGHTS_ALLOW_DIFF_PREFIX)
    logger.info("Imported torch weights from %s (%d leaves kept init)", path, len(missing))
    return True


def apply_pretrained(cfg: Config, model: torch.nn.Module) -> bool:
    """The construction-time chain, in the JAX package's order; returns
    whether cfg.WEIGHTS was imported here (a foreign file)."""
    load_backbone_pretrained(cfg, model)
    load_single_view_pretrained(cfg, model)
    return load_cfg_weights(cfg, model)
