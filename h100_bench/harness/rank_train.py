"""The train driver of a cell over several ranks (one process a card,
`harness/ranks.py`): the port's data-parallel path as `main.py --multihost`
runs it, `engine.trainer.data_parallel` over the model of `build_program`,
then `make_optimizer` and `make_train_step`.  The step stays eager (a CUDA
graph cannot hold DistributedDataParallel's reducer), and BatchNorm takes
the global batch's moments through its all-reduces.

Every rank makes each global batch from the seed as `inputs.train_batches`
makes it and keeps its own rows (SOLVER.IMS_PER_BATCH is the host's batch,
split over its ranks as the port splits it), so the ranks' rows together
are the batch that the reference sees.  Set-up drives the step through the
three checked steps, two more to warm up, and `PACE_STEPS` that rank 0
times; rank 0 broadcasts the number of steps that fills `seconds` at that
pace, and every rank runs exactly that many in the window, so that no rank
stops while another waits in a collective.  The window adds no collective
and no host sync of its own; a traced run traces rank 0's last
`TRACE_SECONDS` of it.

After the window: the largest memory peaks over the ranks, then the group
is left, and rank 0 alone runs the reference on the three global batches
and compares (harness/compare.py), with one number of its own:
  - `rank_gap`: after the three checked steps, the largest over the other
    ranks and over the leaves of the state (parameters and BN's running
    statistics) of ||leaf - rank 0's|| / ||rank 0's||.  DDP's averaged
    gradients and BN's global moments keep every rank's copy the same.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch
import torch.distributed as dist

from epipolar_transformers_tpu_torch import parallel
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.trainer import data_parallel, make_train_step

from . import compare, inputs, work
from .record import RunRecord
from .train import WARMUP_STEPS, build_program, reference_state
from .window import TRACE_SECONDS, Window, warm_profiler

PACE_STEPS = 3  # timed by rank 0 after the warm-up, to fix the window's steps


class CountedWindow(Window):
    """A window of `steps` calls, the last `traced` of them traced."""

    def __init__(self, steps: int, traced: int, trace: bool, device):
        self.steps, self.trace_from = steps, max(0, steps - traced)
        super().__init__(math.inf, trace, device)
        if trace and self.trace_from == 0:
            self._start_trace()

    def tick(self) -> bool:
        self.marks.append(time.perf_counter())
        if self.trace_on and self.prof is None and self.calls >= self.trace_from:
            self._start_trace()
        return self.calls >= self.steps


def agreed_steps(per_step_s: float, seconds: float, device) -> int:
    """Rank 0's count of the steps that fill `seconds` at `per_step_s`,
    broadcast to every rank."""
    count = torch.tensor([max(1, math.ceil(seconds / per_step_s))], dtype=torch.int64,
                         device=device)
    dist.broadcast(count, 0)
    return int(count.item())


def rank_gap(module: torch.nn.Module) -> float:
    """The largest relative gap of any floating leaf of `module`'s state
    between this rank and rank 0, over every rank (every rank calls this)."""
    leaves = [t.detach().reshape(-1) for t in module.state_dict().values()
              if t.is_floating_point()]
    mine = torch.cat(leaves)
    ref = mine.clone()
    dist.broadcast(ref, 0)
    sizes = [t.numel() for t in leaves]
    gaps = [(a - b).norm() / b.norm().clamp(min=1e-30)
            for a, b in zip(mine.split(sizes), ref.split(sizes))]
    worst = torch.stack(gaps).max().reshape(1)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst.item())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(RunRecord, checks, attempted, failed, memory_peak_bytes) of one
    rank's run; the checks are rank 0's, and empty on the other ranks."""
    traffic, recipe = cell.traffic, cell.recipe
    batch = int(recipe["SOLVER"]["IMS_PER_BATCH"])
    rank, world = parallel.rank(), parallel.world()
    mine = parallel.per_rank_batch(batch, parallel.local_world())
    rows = slice(parallel.local_rank() * mine, (parallel.local_rank() + 1) * mine)
    state = reference_state(cell, seed, device)
    cfg, model = build_program(recipe, state, device)
    model.train()
    optimizer = make_optimizer(cfg, model, traffic["steps_per_epoch"])
    step = make_train_step(cfg, data_parallel(cfg, model, device), optimizer)
    rig = inputs.Rig(traffic, recipe, seed, device)
    batches = [{k: v[rows].clone() for k, v in b.items()}
               for b in inputs.train_batches(rig, batch, traffic["batches"])]
    names = {id(p): n[len(compare.PREFIX):] for n, p in model.named_parameters()}

    program = compare.TrainReading()
    heads = []  # the heatmaps of this rank's rows that the first step's forward makes
    hook = model.reference.final_layer.register_forward_hook(
        lambda module, args, output: heads.append(output.detach().float().cpu()))
    for i in range(3):
        out = step(batches[i])
        program.losses.append(float(out["loss"]))
        if i == 0:  # the moments are the averaged gradients, alike on every rank
            hook.remove()
            program.heatmaps1 = heads[0]
            program.grad_norms = {names[id(p)]: float(s["exp_avg"].norm()) / (1 - compare.B1)
                                  for p, s in optimizer.inner.state.items() if "exp_avg" in s}
    with torch.no_grad():
        now = model.state_dict()
        program.change_norms = {n: float((now[compare.PREFIX + n].float() - v).norm())
                                for n, v in state.items() if v.is_floating_point()}
        gap = rank_gap(model)
        del now
    for i in range(WARMUP_STEPS):
        step(batches[(3 + i) % len(batches)])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(PACE_STEPS):
        step(batches[(3 + WARMUP_STEPS + i) % len(batches)])
    _sync(device)
    per_step_s = (time.perf_counter() - t0) / PACE_STEPS
    steps = agreed_steps(per_step_s, seconds, device)
    if trace:
        warm_profiler(device)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    window = CountedWindow(steps, math.ceil(TRACE_SECONDS / per_step_s), trace, device)
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
    peaks = torch.tensor([window_peak, max(setup_peak, window_peak)], dtype=torch.int64,
                         device=device)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)  # the fullest card's
    window_peak, peak = int(peaks[0]), int(peaks[1])

    record = RunRecord(
        kind="train", setup_s=setup_s, window_s=window_s, steps=n, items_per_step=batch,
        peak_window_bytes=window_peak,
        forward_flops_per_item=cell.reference.forward_flops(cell.recipe),
        peak_flops=work.PEAK_FLOPS[cell.config["precision"]],
        trace=traced,
        traced_steps=n - window.traced_from,
        untraced_steps=untraced[0], untraced_s=untraced[1], cards=world)
    if traced is not None:  # the attention calls of this rank's rows
        record.attention_bound_s = work.window_bounds(
            cell, [(b["KRT"], b["other_KRT"]) for b in batches], window.traced_from, n, True)
    del step, optimizer, model, losses, batches
    gc.collect()
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return record, {}, n, failed, peak
    if cuda:
        torch.cuda.empty_cache()

    compare.set_tf32(False)
    t0 = time.perf_counter()
    whole = inputs.train_batches(inputs.Rig(traffic, recipe, seed, device), batch,
                                 traffic["batches"])[:3]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reference = compare.reference_steps(cell, state, whole, device, "float32",
                                        float(recipe["SOLVER"]["BASE_LR"]))
    print(f"reference on the global batch of {batch}: {time.perf_counter() - t0:.1f} s"
          + (f", peak {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB" if cuda else ""),
          file=sys.stderr)
    numbers = compare.train_numbers(program, reference)
    numbers["rank_gap"] = gap
    return record, compare.judge(numbers, cell.limits), n, failed, peak
