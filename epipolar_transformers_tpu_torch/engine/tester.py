"""Evaluation loop, the slice part (PyTorch).

Port of `make_eval_step` and the loader loop of epipolar_transformers_tpu/
engine/tester.py:52-68,299-316.  Test batches are (1, V, ...) view groups;
the batch dimension is squeezed so that the V views become the device
batch.  Triangulation and the metrics are ROADMAP A9.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import Config

EVAL_KEYS = ("img", "KRT", "other_img", "other_KRT")
# what a train step also takes: the target heatmaps and joint visibility
TRAIN_KEYS = EVAL_KEYS + ("heatmap", "visibility")
NHWC_KEYS = ("img", "other_img", "heatmap")


def to_model_inputs(group: Dict[str, np.ndarray], device,
                    keys=EVAL_KEYS) -> Dict[str, torch.Tensor]:
    """Host arrays -> model inputs on `device`.  Images and heatmaps come
    NHWC; permuted to NCHW they are already channels_last in memory, so no
    copy is made."""
    out = {}
    for k in keys:
        t = torch.from_numpy(np.ascontiguousarray(group[k])).to(device, non_blocking=True)
        out[k] = t.permute(0, 3, 1, 2) if k in NHWC_KEYS else t
    return out


def make_eval_step(cfg: Config, model: torch.nn.Module, device) -> Callable:
    """Eval-mode forward over one view group (V views as the batch)."""
    model.eval()

    def eval_step(group: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return model(to_model_inputs(group, device))

    return eval_step


def predict(cfg: Config, model: torch.nn.Module, loader: Iterable,
            max_batches: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """Run the eval forward over `loader`'s view groups on the model's
    device; returns one output dict per group, left on the device (the
    caller decides when to sync)."""
    eval_step = make_eval_step(cfg, model, next(model.parameters()).device)
    outputs = []
    for ib, batch in enumerate(loader):
        if max_batches is not None and ib >= max_batches:
            break
        group = {k: v[0] for k, v in batch.items()}
        outputs.append(eval_step(group))
    return outputs
