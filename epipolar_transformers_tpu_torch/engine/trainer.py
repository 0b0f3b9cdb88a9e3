"""Training engine (PyTorch): the train step and the epoch loop.

Port of epipolar_transformers_tpu/engine/trainer.py:94-261 (reference
engine/trainer.py:18-141) on one device.  `make_train_step` is forward,
`loss.backward()` and the optimizer step; `train` runs the epoch loop with
the LOG_FREQ meters, CHECKPOINT_PERIOD saves, the `last_checkpoint` resume
and `model_final`, as the JAX loop does, and calls `eval_fn(cfg, model)`
every EVAL_FREQ epochs where EVAL_FREQ > 0.

The device is explicit: `train` runs on `cuda:0` unless its caller names
another device, and raises where torch sees no GPU; the CPU runs only when
the caller passes `device="cpu"`.  On the GPU the model runs
channels_last, so the (N, H, W, C) views the attention kernels read need no
copy.  Initial weights come from a `torch.Generator` seeded with cfg.SEED,
drawn with the JAX package's initializers, and so do the lifting net's
dropout masks (a generator on the model's device, never the global RNG);
then `load_weights` imports the pretrained and foreign weights
(utils/pretrained.py) and restores a native checkpoint, as the JAX
`create_train_state` and its Checkpointer do.  A
batch without `img` is a DATALOADER.DEVICE_RENDER batch: only its
coordinates, cameras and visibility go to the device, where
ops/synthetic_render.py renders the images and heatmaps.  Not ported here,
each said when met: DATALOADER.BENCHMARK (ROADMAP A13), tensorboard
(ROADMAP A13, skipped with a log line) and data parallel (ROADMAP A8).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import Config
from ..data.pipeline import make_train_loader
from ..models import ModelBuilder
from ..ops.synthetic_render import RENDER_PARAM_KEYS, make_batch_renderer
from ..utils.checkpoint import Checkpointer
from ..utils.pretrained import apply_pretrained
from .solver import Optimizer, make_optimizer
from .tester import MODEL_KEYS, to_model_inputs

logger = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device: None means cuda:0.  Raises when a CUDA
    device is asked for and torch sees none."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the port runs on {device}, but torch sees no GPU; ask for "
                           "the CPU (device='cpu', or --device cpu) to run there")
    return device


def build_model(cfg: Config, device: torch.device) -> ModelBuilder:
    """The model of `cfg` on `device` (channels_last on a GPU), in train
    mode, with its initial weights drawn from a generator seeded with
    cfg.SEED, and its dropout generator seeded with cfg.SEED."""
    model = ModelBuilder(cfg)
    model.init_weights(torch.Generator().manual_seed(cfg.SEED))
    model.seed_dropout(cfg.SEED)
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model.train()


def load_weights(cfg: Config, model: torch.nn.Module, optimizer: Optional[Optimizer] = None,
                 load_opt: bool = True) -> Optional[Dict]:
    """The pretrained and foreign weights (`apply_pretrained`), then the
    native resume: the `last_checkpoint` tag of OUTPUT_DIR, else a
    cfg.WEIGHTS that the port wrote, which wins over the imports as in the
    JAX package (engine/trainer.py:73-91,163-182 there).  With load_opt
    False (WEIGHTS_LOAD_OPT) the optimizer is not restored.  Returns the
    resumed checkpoint's metadata, or None."""
    imported = apply_pretrained(cfg, model)
    native = cfg.WEIGHTS if cfg.WEIGHTS.endswith(".pth") and not imported else None
    extra = Checkpointer(cfg.OUTPUT_DIR).load(model, optimizer, native, load_opt=load_opt)
    if extra is None and native:
        logger.warning("cfg.WEIGHTS=%r was not loaded (missing file and no last_checkpoint): "
                       "the initial weights stay", cfg.WEIGHTS)
    return extra


def model_inputs(batch, device: torch.device, render: Callable) -> Dict[str, torch.Tensor]:
    """A host train batch -> the model inputs on `device`.  A batch without
    `img` carries joint coordinates instead of pixels (DATALOADER.
    DEVICE_RENDER): only those, the cameras and the visibility are uploaded,
    and `render` (`make_batch_renderer`) splats the images and the target
    heatmaps there."""
    if "img" in batch:
        return to_model_inputs(batch, device, MODEL_KEYS)
    keys = [k for k in MODEL_KEYS if k in batch] + list(RENDER_PARAM_KEYS)
    return render(to_model_inputs(batch, device, keys))


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: Optimizer) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """(model inputs) -> {loss terms and metrics, as detached tensors}: one
    forward, backward and optimizer step, the model in train mode."""

    def train_step(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        loss_dict, metric_dict, _ = model(inputs)
        optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in {**loss_dict, **metric_dict}.items()}

    return train_step


def check_supported(cfg: Config) -> None:
    """Raise on what the port's train loop does not run yet."""
    if cfg.DATALOADER.BENCHMARK:
        raise NotImplementedError("DATALOADER.BENCHMARK (the loader-only benchmark) is "
                                  "ROADMAP A13 in the port")


def train(cfg: Config, max_steps: Optional[int] = None, device=None,
          eval_fn: Optional[Callable[[Config, ModelBuilder], Dict]] = None
          ) -> Tuple[ModelBuilder, Optimizer]:
    """The training loop; returns the model and its optimizer, whose
    `count` is the number of optimizer updates, restored ones included.

    Args:
        max_steps: stop after this many steps of this call (smoke runs and
            tests), before the epoch's checkpoint, as the JAX loop does.
        device: where to train; None means cuda:0, and the CPU runs only
            when asked for ("cpu").
        eval_fn: called as eval_fn(cfg, model) every EVAL_FREQ epochs
            (reference trainer.py:139-141); EVAL_FREQ <= 0 never calls it.
    """
    device = resolve_device(device)
    check_supported(cfg)
    if cfg.TENSORBOARD.USE:
        logger.info("TENSORBOARD.USE: the port writes no event files yet (ROADMAP A13)")
    loader = make_train_loader(cfg)
    steps_per_epoch = max(len(loader), 1)
    model = build_model(cfg, device)
    optimizer = make_optimizer(cfg, model, steps_per_epoch)

    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    start_epoch = 0
    extra = load_weights(cfg, model, optimizer, load_opt=cfg.WEIGHTS_LOAD_OPT)
    if extra is not None:
        start_epoch = int(extra.get("epoch", 0))
        logger.info("Resumed from epoch %d", start_epoch)

    train_step = make_train_step(cfg, model, optimizer)
    render = make_batch_renderer(cfg)
    step = 0
    t_data = t_step = 0.0
    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCHS):
        t0 = time.time()
        for batch in loader:
            inputs = model_inputs(batch, device, render)
            t_data += time.time() - t0
            metrics = train_step(inputs)
            step += 1
            t_step += time.time() - t0
            if step % cfg.LOG_FREQ == 0:
                values = {k: float(v) for k, v in metrics.items()}
                logger.info("epoch %d step %d  %s  data_t %.3f step_t %.3f", epoch, step,
                            "  ".join(f"{k} {v:.6g}" for k, v in values.items()),
                            t_data / step, t_step / step)
            if max_steps is not None and step >= max_steps:
                return model, optimizer
            t0 = time.time()
        if (epoch + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            checkpointer.save(f"model_{epoch:03d}", model, optimizer, epoch=epoch + 1)
        if eval_fn is not None and cfg.EVAL_FREQ > 0 and (epoch + 1) % cfg.EVAL_FREQ == 0:
            eval_fn(cfg, model)
    if cfg.SOLVER.MAX_EPOCHS > start_epoch:
        checkpointer.save("model_final", model, optimizer, epoch=cfg.SOLVER.MAX_EPOCHS)
    return model, optimizer
