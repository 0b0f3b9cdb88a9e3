"""The inference cell's driver: a closed loop of one live rig through the
port's eval engine.

One view group at a time goes through `engine.tester.make_eval_step`, then
`fetch_outputs`, then `process_group` (pymvg), with two groups in flight in
the double-buffered order of `engine.tester._evaluate`: group n+1's forward
is queued before the host waits for group n's copies and triangulates it.
The groups are made at set-up from the seed and served from host memory in
turn.  A group's latency runs from the call of the eval step until its 3D
pose is on the host.  VIS.SAVE_PRED hands each group's pose to the caller
(the entry is taken off again at once).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from epipolar_transformers_tpu_torch.engine.tester import (EvalRecord, fetch_outputs,
                                                          host_output_keys, make_eval_step,
                                                          process_group)

from . import compare, inputs, work
from .record import RunRecord
from .train import build_program, reference_state
from .window import Window, warm_profiler

SAVE_PRED = {"SAVE_PRED": True, "SAVE_PRED_FREQ": 1, "SAVE_PRED_LIMIT": -1}


class Loop:
    """The double-buffered drive of one eval step over the pool of groups."""

    def __init__(self, cfg, eval_step, groups: List[Dict], cuda: bool, keep: set):
        self.cfg, self.eval_step, self.groups, self.cuda = cfg, eval_step, groups, cuda
        self.keys = host_output_keys(cfg, groups[0])
        self.record = EvalRecord()
        self.keep = keep  # pool indices whose latest outputs are kept
        self.span = lambda name: contextlib.nullcontext()  # the window's, once it opens
        self.kept: Dict[int, Dict] = {}
        self.reset()

    def reset(self):
        self.kept.clear()
        self.latencies: List[float] = []
        self.forward_events: List[tuple] = []
        self.host_half_ms: List[float] = []
        self.poses: List[np.ndarray] = []
        self.pending = None

    def launch(self, i: int):
        g = self.groups[i % len(self.groups)]
        t = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
            if self.cuda else None
        with self.span("bench.eval_step"):
            if ev:
                ev[0].record()
            out = self.eval_step(g)
            if ev:
                ev[1].record()
        with self.span("bench.fetch"):
            host, done = fetch_outputs(out, self.keys)
        current = (i, g, host, done, t, ev)
        if self.pending is not None:
            self.finish(self.pending)
        self.pending = current

    def drain(self):
        if self.pending is not None:
            self.finish(self.pending)
            self.pending = None

    def finish(self, p):
        i, g, host, done, t, ev = p
        with self.span("bench.wait"):
            if done is not None:
                done.synchronize()
        with self.span("bench.host_half"):
            h0 = time.perf_counter()
            out = {k: v.numpy() for k, v in host.items()}
            process_group(self.cfg, g, out, self.record, i)
            pose = self.record.predictions.pop()["pred3d"]
            h1 = time.perf_counter()
        self.latencies.append(h1 - t)
        self.host_half_ms.append((h1 - h0) * 1e3)
        self.poses.append(pose)
        if ev:
            self.forward_events.append(ev)
        if i % len(self.groups) in self.keep:
            self.kept[i % len(self.groups)] = {**out, "pred3d": pose, "group": g}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """(RunRecord, checks, attempted, failed, memory_peak_bytes) of one run."""
    traffic, recipe = cell.traffic, cell.recipe
    cuda = torch.device(device).type == "cuda"
    state = reference_state(cell, seed, device)
    rig = inputs.Rig(traffic, recipe, seed, device)
    groups = inputs.infer_groups(rig, traffic["groups"])
    cfg, model = build_program({**recipe, "VIS": {**recipe.get("VIS", {}), **SAVE_PRED}},
                               state, device)
    eval_step = make_eval_step(cfg, model, device)
    keep = set(np.random.default_rng(int(seed)).choice(len(groups), traffic["checked_groups"],
                                                       replace=False).tolist())
    loop = Loop(cfg, eval_step, groups, cuda, keep)
    for i in range(traffic["warmup_groups"]):
        loop.launch(i)
    loop.drain()
    if trace:
        warm_profiler(device)
    if cuda:
        torch.cuda.synchronize(device)
    loop.reset()
    setup_s = time.perf_counter() - t_start

    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    window = Window(seconds, trace, device)
    loop.span = window.span
    while True:
        loop.launch(window.calls)
        if window.tick():
            break
    loop.drain()
    window_s, traced = window.close()
    n = window.calls
    untraced = window.untraced()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(1 for p in loop.poses if not np.isfinite(p).all())
    V = len(groups[0]["img"])
    record = RunRecord(
        kind="infer", setup_s=setup_s, window_s=window_s, steps=n, items_per_step=V,
        peak_window_bytes=window_peak,
        # the reference's count is per item of two views; a group is V views
        # and their V others, the forward at batch V
        forward_flops_per_item=cell.reference.forward_flops(cell.recipe),
        peak_flops=work.PEAK_FLOPS[cell.config["precision"]],
        latencies_s=loop.latencies,
        eval_forward_ms=[a.elapsed_time(b) for a, b in loop.forward_events],
        host_half_ms=loop.host_half_ms, trace=traced, traced_steps=n - window.traced_from,
        untraced_steps=untraced[0], untraced_s=untraced[1])
    if traced is not None:
        record.attention_bound_s = work.window_bounds(
            cell, [(torch.as_tensor(g["KRT"], device=device),
                    torch.as_tensor(g["other_KRT"], device=device)) for g in groups],
            window.traced_from, n, False)
    kept = [loop.kept[i] for i in sorted(loop.kept)]
    del loop, eval_step, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    compare.set_tf32(False)
    ref = compare.infer_reference_heatmaps(cell, state, [k["group"] for k in kept], device,
                                           "float32")
    checks = compare.judge(compare.infer_numbers(cell, kept, ref), cell.limits)
    return record, checks, n, failed, max(setup_peak, window_peak)
