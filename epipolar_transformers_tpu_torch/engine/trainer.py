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
each said when met: DATALOADER.BENCHMARK (ROADMAP A13) and tensorboard
(ROADMAP A13, skipped with a log line).

Under a process group (parallel/: `--multihost`, or a group the caller
made) every rank builds the same seeded model, checks once that all hold
bit-equal weights, and trains its share of each batch under
DistributedDataParallel, which averages the gradients; BatchNorm takes the
global batch's moments (models/layers.py) and the count-normalised losses
the global count, so a step is the JAX package's step on the whole batch.
Rank 0 alone saves checkpoints and runs `eval_fn` while the others wait at
a barrier, and logs the step's values averaged over the ranks.  On the GPU
each logged step also reports its device time (CUDA events) and the peak
device memory so far.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..config import Config
from ..data.pipeline import make_train_loader
from ..models import ModelBuilder
from ..models.layers import BatchNorm2d
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


def data_parallel(cfg: Config, model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`model` under DistributedDataParallel in a process group (of one rank
    too, as torchrun --nproc_per_node 1 makes it), else `model` itself.
    Checks first that every
    rank holds the same weights, and that every BatchNorm is one that takes
    the global batch's moments (a torch BatchNorm would train on its rank's).
    The BN statistics agree by construction, so no buffer is broadcast; the
    sibling backbone of unshared weights runs under no-grad (without
    EPIPOLAR.OTHER_GRAD), the one case where parameters get no gradient."""
    if not parallel.distributed():
        return model
    local = [n for n, m in model.named_modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
             and not isinstance(m, BatchNorm2d)]
    if local:
        raise ValueError(f"{local[:3]} would train on each rank's own moments under "
                         f"{parallel.world()} ranks; the port's BatchNorm2d takes the global "
                         "batch's")
    parallel.check_same_on_every_rank(model)
    c = cfg.EPIPOLAR
    unused = (cfg.DATASETS.TASK in ("multiview_keypoint", "multiview_img_lifting_rot")
              and not c.SHARE_WEIGHTS and not c.OTHER_GRAD)
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=unused)


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

    train_step = make_train_step(cfg, data_parallel(cfg, model, device), optimizer)
    render = make_batch_renderer(cfg)
    timer = _StepTimer(device)
    step = 0
    t_data = t_step = 0.0
    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCHS):
        t0 = time.time()
        for batch in loader:
            inputs = model_inputs(batch, device, render)
            t_data += time.time() - t0
            with timer:
                metrics = train_step(inputs)
            step += 1
            t_step += time.time() - t0
            if step % cfg.LOG_FREQ == 0:
                values = parallel.mean_over_ranks(metrics)
                if parallel.is_primary():
                    logger.info("epoch %d step %d  %s  data_t %.3f step_t %.3f%s", epoch, step,
                                "  ".join(f"{k} {v:.6g}" for k, v in values.items()),
                                t_data / step, t_step / step, timer.report())
            if max_steps is not None and step >= max_steps:
                return model, optimizer
            t0 = time.time()
        if (epoch + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            _on_primary(checkpointer.save, f"model_{epoch:03d}", model, optimizer,
                        epoch=epoch + 1)
        if eval_fn is not None and cfg.EVAL_FREQ > 0 and (epoch + 1) % cfg.EVAL_FREQ == 0:
            _on_primary(eval_fn, cfg, model)
    if cfg.SOLVER.MAX_EPOCHS > start_epoch:
        _on_primary(checkpointer.save, "model_final", model, optimizer,
                    epoch=cfg.SOLVER.MAX_EPOCHS)
    return model, optimizer


def _on_primary(fn, *args, **kwargs) -> None:
    """fn on rank 0 alone (no collective inside) while the other ranks wait."""
    if parallel.is_primary():
        with parallel.alone():
            fn(*args, **kwargs)
    parallel.barrier()


class _StepTimer:
    """CUDA events around each train step; `report` gives the last step's
    device ms and the peak device memory for the step log line (nothing on
    the CPU)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def __enter__(self):
        if self.cuda:
            self.events[0].record()

    def __exit__(self, *exc):
        if self.cuda:
            self.events[1].record()

    def report(self) -> str:
        if not self.cuda:
            return ""
        self.events[1].synchronize()
        return (f" device_ms {self.events[0].elapsed_time(self.events[1]):.3f}"
                f" peak_gib {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}")
