"""Checkpointing with `last_checkpoint` resume (PyTorch).

Port of epipolar_transformers_tpu/utils/checkpoint.py (reference
utils/checkpoint.py:9-103), torch-native: `save` writes the model's and the
optimizer's state dicts (the optimizer carries the LR schedule's count)
plus metadata such as the epoch to `<name>.pth` with `torch.save`, and tags
it in `last_checkpoint`.  `load` prefers the tagged file over an explicit
path (the tag wins over cfg.WEIGHTS, as in the reference), and with
load_opt=False (WEIGHTS_LOAD_OPT) restores the model weights only.

A file `save` wrote holds exactly the keys {"model", "optimizer", "extra"}
(`is_native`); any other `.pth` is a foreign torch file, which
utils/pretrained.py imports instead.

A JAX checkpoint (a flax msgpack `.ckpt`, in cfg.WEIGHTS or tagged in
`last_checkpoint`) loads too, weights only: its `state.params` and
`state.batch_stats` through `utils/jax_import.load_jax_variables`, as
the JAX `Checkpointer.load` restores them under WEIGHTS_LOAD_OPT=False.
Its optimizer state (optax's, in flax's layout) is not read; its `extra`
(the epoch) is returned as it is.
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING, Any, Dict, Optional

import torch

from .flax_msgpack import read_checkpoint
from .jax_import import load_jax_variables

if TYPE_CHECKING:  # engine/ imports this module
    from ..engine.solver import Optimizer

logger = logging.getLogger(__name__)


class Checkpointer:
    NATIVE_KEYS = frozenset({"model", "optimizer", "extra"})

    def __init__(self, save_dir: str = ""):
        self.save_dir = save_dir
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

    @classmethod
    def is_native(cls, payload) -> bool:
        """Whether an unpickled `.pth` payload is one that `save` wrote."""
        return isinstance(payload, dict) and set(payload) == cls.NATIVE_KEYS

    def save(self, name: str, model: torch.nn.Module,
             optimizer: Optional[Optimizer] = None, **extra) -> None:
        """Write `<name>.pth` and tag it as the last checkpoint."""
        if not self.save_dir:
            return
        payload = {"model": model.state_dict(),
                   "optimizer": None if optimizer is None else optimizer.state_dict(),
                   "extra": extra}
        path = os.path.join(self.save_dir, f"{name}.pth")
        # write then rename, so an interrupted save never leaves a torn file
        # under the tagged name
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        self.tag_last_checkpoint(f"{name}.pth")
        logger.info("Saved checkpoint to %s", path)

    def load(self, model: torch.nn.Module, optimizer: Optional[Optimizer] = None,
             path: Optional[str] = None, load_opt: bool = True) -> Optional[Dict[str, Any]]:
        """Restore the tagged checkpoint, else `path`; returns its metadata,
        or None when there is nothing to load."""
        if self.has_checkpoint():
            path = os.path.join(self.save_dir, self.get_checkpoint_file())
        if not path or not os.path.exists(path):
            return None
        if path.endswith(".ckpt"):
            params, stats, extra = read_checkpoint(path)
            load_jax_variables(model, {"params": params, "batch_stats": stats})
            logger.info("Loaded model weights only (WEIGHTS_LOAD_OPT=False) from %s", path)
            return extra
        # these files are written by `save` above: plain state dicts and
        # python scalars, which the weights-only unpickler accepts
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        if load_opt and optimizer is not None and payload.get("optimizer") is not None:
            optimizer.load_state_dict(payload["optimizer"])
            logger.info("Loaded checkpoint from %s", path)
        else:
            logger.info("Loaded model weights only (WEIGHTS_LOAD_OPT=False) from %s", path)
        return payload.get("extra", {})

    def has_checkpoint(self) -> bool:
        return bool(self.save_dir) and os.path.exists(
            os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                return f.read().strip()
        except OSError:
            return ""

    def tag_last_checkpoint(self, filename: str) -> None:
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(filename)
