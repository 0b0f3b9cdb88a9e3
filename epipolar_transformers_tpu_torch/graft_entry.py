"""The port's entry point: the flagship forward as a function and its inputs.

    from epipolar_transformers_tpu_torch.graft_entry import entry
    fn, example_args = entry()            # on cuda:0
    heatmap_pred, batch_locs, score_pred = fn(*example_args)

The counterpart of the repository's `__graft_entry__.entry()`: the flagship
(`config.flagship_cfg()`: epipolarposeR-50, 256 px, 64x64 heatmaps, 17
joints, K=64, bf16 convolutions with f32 parameters) built by
`engine.trainer.build_model`, its weights drawn from a `torch.Generator`
seeded with cfg.SEED where the JAX entry draws them from
`PRNGKey(0)`, and one synthetic training item (the reference view and its
nearest other view) as the example.  `fn(img, other_img, KRT, other_KRT)`
takes the port's layout, (N, 3, H, W) images and (N, 3, 4) cameras, and
runs the eval forward, whose attention is the CUDA kernel on the card.
It runs on cuda:0 unless `device` asks for another, and raises where torch
sees no GPU.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .config import flagship_cfg
from .data.datasets.synthetic import SyntheticMultiview
from .data.pipeline import collate
from .engine.tester import to_model_inputs
from .engine.trainer import build_model, resolve_device

ARGS = ("img", "other_img", "KRT", "other_KRT")


def entry(device=None, tiny: bool = False) -> Tuple[Callable, Tuple[torch.Tensor, ...]]:
    """Return (fn, example_args): the flagship's eval forward on `device`
    (cuda:0 by default) and one synthetic item's inputs there.  `tiny`
    builds the CPU tests' proxy (`flagship_cfg(tiny=True)`)."""
    device = resolve_device(device)
    cfg = flagship_cfg(tiny)
    batch = collate([SyntheticMultiview(cfg, is_train=True, n_samples=1)[0]])
    inputs = to_model_inputs(batch, device)
    model = build_model(cfg, device).eval()

    def fn(img, other_img, KRT, other_KRT):
        with torch.inference_mode():
            out = model({"img": img, "other_img": other_img, "KRT": KRT,
                         "other_KRT": other_KRT})
        return out["heatmap_pred"], out["batch_locs"], out["score_pred"]

    return fn, tuple(inputs[k] for k in ARGS)
