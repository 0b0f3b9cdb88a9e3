"""The train cells' driver: back-to-back calls of the port's
`engine.trainer.make_train_step` on batches made on the device.

Set-up builds one model and its adam, loads the seed's weights, and drives
that same step through three checked steps on three distinct batches (what
the reference follows), then two more; the window then calls it on the
pool of batches in turn until `seconds` have passed on the host's clock,
and waits for the device.  The rate is the items of every step over the
whole window.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Tuple

import torch

from epipolar_transformers_tpu_torch.config import Config, update_from_dict
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.trainer import make_train_step
from epipolar_transformers_tpu_torch.models import ModelBuilder

from . import compare, inputs, weights, work
from .record import RunRecord
from .window import Window, warm_profiler

WARMUP_STEPS = 2  # after the three checked steps


def build_program(recipe: Dict, state: Dict[str, torch.Tensor], device
                  ) -> Tuple[Config, ModelBuilder]:
    """The port's model of `recipe` on `device`, holding `state`."""
    cfg = update_from_dict(Config(), recipe)
    with torch.device(device):
        model = ModelBuilder(cfg)
    missing, unexpected = model.load_state_dict(
        {compare.PREFIX + k: v for k, v in state.items()}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"the port's model and the reference's state differ: missing "
                           f"{missing[:5]}, unexpected {unexpected[:5]}")
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return cfg, model


def reference_state(cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights for the cell's model, on `device`."""
    ref = cell.reference
    return weights.make_state(ref.state_shapes(cell.recipe), seed, device,
                              **getattr(ref, "weight_rules", {}))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(RunRecord, checks, attempted, failed, memory_peak_bytes) of one run."""
    traffic, recipe = cell.traffic, cell.recipe
    batch = int(recipe["SOLVER"]["IMS_PER_BATCH"])
    state = reference_state(cell, seed, device)
    cfg, model = build_program(recipe, state, device)
    model.train()
    optimizer = make_optimizer(cfg, model, traffic["steps_per_epoch"])
    step = make_train_step(cfg, model, optimizer)
    rig = inputs.Rig(traffic, recipe, seed, device)
    batches = inputs.train_batches(rig, batch, traffic["batches"])
    names = {id(p): n[len(compare.PREFIX):] for n, p in model.named_parameters()}

    program = compare.TrainReading()
    heads = []  # the heatmaps that the first step's own forward makes
    hook = model.reference.final_layer.register_forward_hook(
        lambda module, args, output: heads.append(output.detach().float().cpu()))
    for i in range(3):
        out = step(batches[i])
        program.losses.append(float(out["loss"]))
        if i == 0:  # a leaf left without a moment saw no gradient (reads as zero)
            hook.remove()
            program.heatmaps1 = heads[0]
            program.grad_norms = {names[id(p)]: float(s["exp_avg"].norm()) / (1 - compare.B1)
                                  for p, s in optimizer.inner.state.items() if "exp_avg" in s}
    with torch.no_grad():
        now = model.state_dict()
        program.change_norms = {n: float((now[compare.PREFIX + n].float() - v).norm())
                                for n, v in state.items() if v.is_floating_point()}
    for i in range(WARMUP_STEPS):
        step(batches[(3 + i) % len(batches)])
    if trace:
        warm_profiler(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    window = Window(seconds, trace, device)
    while True:
        with window.span("bench.train_step"):
            losses.append(step(batches[window.calls % len(batches)])["loss"])
        if window.tick():
            break
    window_s, traced = window.close()
    n = window.calls
    untraced = window.untraced()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    record = RunRecord(
        kind="train", setup_s=setup_s, window_s=window_s, steps=n, items_per_step=batch,
        peak_window_bytes=window_peak,
        forward_flops_per_item=cell.reference.forward_flops(cell.recipe),
        peak_flops=work.PEAK_FLOPS[cell.config["precision"]],
        trace=traced,
        traced_steps=n - window.traced_from,
        untraced_steps=untraced[0], untraced_s=untraced[1])
    if traced is not None:
        record.attention_bound_s = work.window_bounds(
            cell, [(b["KRT"], b["other_KRT"]) for b in batches], window.traced_from, n, True)
    del step, optimizer, model, losses
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    compare.set_tf32(False)
    reference = compare.reference_steps(cell, state, batches, device, "float32",
                                        float(recipe["SOLVER"]["BASE_LR"]))
    checks = compare.judge(compare.train_numbers(program, reference), cell.limits)
    return record, checks, n, failed, max(setup_peak, window_peak)
