"""Parameter and FLOP accounting (VIS.FLOPS) and the loader's stage timers
(DATALOADER.BENCHMARK).

Port of epipolar_transformers_tpu/utils/profiling.py (reference
engine/tester.py:36-43, scripts/compute_complexiy.py, joints_dataset.py:
187,280-281).  The JAX package counts the compiled program's FLOPs with
XLA's `cost_analysis`; the port counts the eval forward with
`torch.utils.flop_counter.FlopCounterMode`, which counts the matmuls and
convolutions (2 per multiply-add) that the forward dispatches and nothing
elementwise (BatchNorm, ReLU, the adds), where XLA counts those too.

The epipolar attention is counted by formula, whatever route computes it:
the similarity and the weighted sum, each 2*B*H*W*K*C flops for B views of
H*W queries, K samples on each line and C channels (the query width for
the first, the value width for the second).  On the card the counter sees
nothing of the hand kernel, which is bound through ctypes; on the CPU it
would count the plain version's corner gathers and einsums; so the ops
that the attention dispatches are taken out of the count and the formula
put in their place, and a forward counts the same on every route.  XLA's
count of the JAX matmul form is larger: that form builds one-hot bilinear
profiles and the (HW, HW) Gram matrix of every query with every key row,
2*B*(HW)^2*C for the Gram matrix alone, where the line's K samples touch
at most 4K rows.

`trace_summary` reads a `--trace` file: the device's busy share over the
train steps and each kernel's launches and time.

`DATALOADER_STAGES` is the sink the datasets' stage timers write into
(data/datasets/joints_dataset.py).  A loader worker process writes its own
copy of it; data/pipeline.py ships what each worker measured back with
each item and adds it to the consumer's, so the report holds the workers'
times too.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import torch


def count_params(model: torch.nn.Module) -> int:
    """The model's parameters (not its buffers: the BN running statistics
    are the JAX package's `batch_stats`, which its count leaves out too)."""
    return int(sum(p.numel() for p in model.parameters()))


class StageTimes:
    """Per-stage wall-time accumulator for DATALOADER.BENCHMARK: each stage's
    seconds and count, averaged in `report`."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, stage: str, seconds: float, count: int = 1):
        self.times[stage] = self.times.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + count

    def averages(self) -> Dict[str, float]:
        return {k: self.times[k] / max(self.counts[k], 1) for k in self.times}

    def reset(self):
        self.times.clear()
        self.counts.clear()

    def take(self) -> Optional[Dict[str, Tuple[float, int]]]:
        """What was added since the last take or reset, as {stage: (seconds,
        count)}, and reset; None where nothing was."""
        if not self.times:
            return None
        out = {k: (self.times[k], self.counts[k]) for k in self.times}
        self.reset()
        return out

    def merge(self, taken: Dict[str, Tuple[float, int]]):
        """Add what another process's `take` returned."""
        for stage, (seconds, count) in taken.items():
            self.add(stage, seconds, count)

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1e3:.2f}ms" for k, v in sorted(self.averages().items()))


# the sink the datasets write into under DATALOADER.BENCHMARK
DATALOADER_STAGES = StageTimes()


def attention_flops(q: torch.Tensor, v: torch.Tensor, sample_locs: torch.Tensor) -> int:
    """The attention's FLOPs by formula: (B, H, W, Cq) queries, (B, H, W, Cv)
    values, (B, K, H, W, 2) sample locations -> 2*B*H*W*K*(Cq + Cv)."""
    B, K, H, W, _ = sample_locs.shape
    return 2 * B * H * W * K * (q.shape[-1] + v.shape[-1])


class _FormulaAttention:
    """An Epipolar layer's `attend` under a FlopCounterMode: the ops it
    dispatches are noted (to be taken out of the count) and the formula's
    FLOPs added."""

    def __init__(self, counter, attend, tally):
        self.counter, self.attend, self.tally = counter, attend, tally

    def __call__(self, q, k, v, sample_locs, prior=None):
        before = self.counter.get_total_flops()
        out = self.attend(q, k, v, sample_locs, prior)
        self.tally["dispatched"] += self.counter.get_total_flops() - before
        self.tally["formula"] += attention_flops(q, v, sample_locs)
        return out


def profile_model(cfg, batch_size: int = 1, device=None, batch=None) -> Dict[str, float]:
    """Parameters and eval-forward FLOPs of the configured model on
    `batch_size` synthetic items (the JAX `profile_model`), or on `batch`,
    a collated host batch (the recipe's own items: the synthetic ones carry
    no lifting targets, so the lifting tasks need theirs): the model built
    as `train` builds it, in eval mode, on `device` (cuda:0 unless the
    caller asks for the CPU).  `flops` counts the matmuls and convolutions
    and the attention by formula (the module docstring), `attention_flops`
    the formula's share, `conv_flops` the convolutions' (transposed ones
    included).  `bytes_accessed` is NaN: the port has no count of
    the bytes a forward moves (the JAX package prints NaN where XLA's
    analysis omits a key)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..data.datasets.synthetic import SyntheticMultiview
    from ..data.pipeline import collate
    from ..engine.tester import MODEL_KEYS, to_model_inputs
    from ..engine.trainer import build_model, resolve_device
    from ..models.epipolar import Epipolar

    device = resolve_device(device)
    if batch is None:
        ds = SyntheticMultiview(cfg, is_train=True, n_samples=batch_size, device_render=False)
        batch = collate([ds[i] for i in range(batch_size)])
    inputs = to_model_inputs(batch, device, MODEL_KEYS)
    model = build_model(cfg, device).eval()
    counter = FlopCounterMode(display=False)
    tally = {"dispatched": 0, "formula": 0}
    layers = [m for m in model.modules() if isinstance(m, Epipolar)]
    for m in layers:
        m.attend = _FormulaAttention(counter, m.attend, tally)
    try:
        with torch.inference_mode(), counter:
            model(inputs)
    finally:
        for m in layers:
            del m.attend
    total = counter.get_total_flops() - tally["dispatched"] + tally["formula"]
    conv = sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op))
    return {
        "params": count_params(model),
        "flops": float(total),
        "bytes_accessed": float("nan"),
        "attention_flops": float(tally["formula"]),
        "conv_flops": float(conv),
    }



# the Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path: str, span: str = "train_step") -> Dict:
    """A `torch.profiler` Chrome trace (main.py --trace) summed up: the
    window from the start of the first `span` annotation (the train loop
    marks each step) to the end of the last, or of the device work that
    started inside it; the device's busy time in that window (the union of
    its kernels, copies and fills), its share of the window, and over the
    whole trace each kernel's launches and device ms by name."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                    for e in events if e.get("cat") in DEVICE_CATEGORIES)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == span]
    kernels: Dict[str, list] = {}
    for t0, t1, name in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t1 - t0) / 1e3
    out = {"steps": len(spans), "device_events": len(device),
           "kernels": {k: {"launches": n, "ms": ms} for k, (n, ms) in kernels.items()}}
    if not spans:
        return out
    start = min(a for a, _ in spans)
    end = max(b for _, b in spans)
    end = max([end] + [t1 for t0, t1, _ in device if start <= t0 < end])
    busy, cur = 0.0, start
    for t0, t1, _ in device:
        t0, t1 = max(t0, cur), min(t1, end)
        if t1 > t0:
            busy += t1 - t0
            cur = t1
    out.update(window_ms=(end - start) / 1e3, busy_ms=busy / 1e3,
               busy_share=busy / max(end - start, 1e-9))
    return out
