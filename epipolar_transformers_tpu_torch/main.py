"""The port's command line: train and evaluate on the card.

    python -m epipolar_transformers_tpu_torch.main --cfg configs/foo.yaml [KEY VALUE ...]

Port of the repository's root `main.py` (reference main.py:21-75): the same
YAML and `KEY VALUE` overrides, dispatching DOTRAIN (with the periodic eval
when DOTEST is set) and then DOTEST, and printing `RESULTS: {...}`.  It runs
on `--device`, cuda:0 by default, and raises where torch sees no GPU; the
CPU runs only when asked for (`--device cpu`).  The eval-only branch builds
the model, imports the pretrained and foreign weights (a reference `.pth`
in cfg.WEIGHTS), then restores a native checkpoint: the `last_checkpoint`
of OUTPUT_DIR, which wins, or a cfg.WEIGHTS that the port wrote.

`--multihost` trains data parallel, one rank a GPU, under torchrun:

    torchrun --nproc_per_node N -m epipolar_transformers_tpu_torch.main --multihost \
        --cfg configs/foo.yaml [KEY VALUE ...]

Each rank joins the NCCL group of torchrun's environment on
cuda:LOCAL_RANK (gloo on the CPU with `--device cpu`) and trains its share
of each batch (parallel/, engine/trainer.py); rank 0 alone runs the evals,
logs and prints RESULTS, while the others wait.  The group is left at the
end and on an error.

VIS.FLOPS prints the model's parameters and eval-forward FLOPs as
`PROFILE: {...}` and stops (utils/profiling.py).  `--trace DIR` runs the
train/test dispatch under `torch.profiler` (the host's ops and, on the
card, its kernels) and writes a Chrome/Perfetto trace, DIR/trace.json, or
DIR/trace_rank<r>.json for each rank under --multihost; the port's spans
(utils/tracing.py) are ranges of that trace, and each span's calls, host
ms, self ms, device ms and host syncs are logged after it.

Under VIS.DOVIS, a VIS mode (POINTCLOUD, AUC, VIDEO, EPIPOLAR_LINE,
CURSOR) runs the visualization dispatch (vis/visualization.py) after the
train/test dispatch, as the root main.py does, and prints `VIS: {...}`;
EPIPOLAR_LINE and CURSOR run their layer on the same device.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from . import parallel
from .config import load_config
from .data.pipeline import stop_workers
from .engine import test, train
from .engine.trainer import build_model, load_weights, resolve_device
from .utils import tracing
from .utils.profiling import profile_model
from .vis.visualization import visualization

logger = logging.getLogger("main")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="epipolar-transformers (PyTorch port)")
    parser.add_argument("--cfg", dest="cfg", default=None, help="config yaml")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="cap total train steps (smoke runs)")
    parser.add_argument("--max-eval-batches", type=int, default=None,
                        help="cap eval batches (smoke runs)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default cuda:0; 'cpu' runs on the CPU)")
    parser.add_argument("--multihost", action="store_true",
                        help="data parallel over the ranks that torchrun starts")
    parser.add_argument("--trace", metavar="DIR", default=None,
                        help="write a torch.profiler trace of the run into DIR (open with "
                             "Perfetto or chrome://tracing)")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE config override pairs")
    return parser.parse_args(argv)


def _wants_visualization(cfg) -> bool:
    """Root main.py `_maybe_visualize`: a concrete VIS mode under DOVIS."""
    v = cfg.VIS
    return v.DOVIS and (v.POINTCLOUD or v.AUC or v.VIDEO or v.EPIPOLAR_LINE or v.CURSOR)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.cfg, args.opts)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
                        stream=sys.stdout)

    if not args.multihost:
        return run(cfg, args, resolve_device(args.device))
    device = parallel.init_distributed(args.device)
    try:
        if not parallel.is_primary():
            logging.getLogger().setLevel(logging.WARNING)
        return run(cfg, args, device)
    finally:
        parallel.shutdown()
        stop_workers()  # the loader's forkserver and resource tracker would outlive the rank


def run(cfg, args, device):
    """Train and/or evaluate `cfg` on `device`; under a process group, rank
    0 alone evaluates and prints RESULTS (the others return None)."""
    if cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    np.random.seed(cfg.SEED)
    if cfg.DEBUG_NANS:
        torch.autograd.set_detect_anomaly(True)
    logger.info("device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "host")
    logger.info("task=%s backbone=%s", cfg.DATASETS.TASK, cfg.BACKBONE.BODY)
    if cfg.VIS.FLOPS:
        # reference tester.py:36-43: print the parameters and FLOPs and stop
        prof = profile_model(cfg, device=device)
        if parallel.is_primary():
            print("PROFILE:", prof)
        return prof
    if not args.trace:
        return dispatch(cfg, args, device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, f"trace_rank{parallel.rank()}.json" if args.multihost
                        else "trace.json")
    tracing.enable(annotate=True)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            results = dispatch(cfg, args, device)
    finally:
        tracing.disable()
    prof.export_chrome_trace(path)
    logger.info("profiler trace -> %s", path)
    spans, counters = tracing.drain()
    for name, row in tracing.summary(spans, counters).items():
        logger.info("span %s: %s", name, {k: round(v, 3) for k, v in row.items()})
    for (index, name), n in counters.items():
        if index < 0:
            logger.info("counter %s: %d", name, n)
    return results


def dispatch(cfg, args, device):
    """DOTRAIN, with the periodic eval under DOTEST, then DOTEST, then the
    VIS modes (root main.py `_maybe_visualize`, on rank 0 alone)."""
    results = _train_test(cfg, args, device)
    if _wants_visualization(cfg) and parallel.is_primary():
        with parallel.alone():
            print("VIS:", visualization(cfg, device))
    return results


def _train_test(cfg, args, device):
    model = None
    if cfg.DOTRAIN:
        eval_fn = None
        if cfg.DOTEST:
            def eval_fn(c, m):  # noqa: E306
                return test(c, m, max_batches=args.max_eval_batches)
        model, _ = train(cfg, max_steps=args.max_steps, device=device, eval_fn=eval_fn)
    if not cfg.DOTEST:
        return None
    results = None
    if parallel.is_primary():
        with parallel.alone():
            results = evaluate(cfg, args, device, model)
    parallel.barrier()
    return results


def evaluate(cfg, args, device, model):
    if model is None:
        # eval-only: build the model, then the foreign imports and the
        # native restore (root main.py:109-131); an unloadable WEIGHTS warns
        model = build_model(cfg, device)
        if load_weights(cfg, model, load_opt=False) is None and not cfg.WEIGHTS:
            logger.warning("no checkpoint found; evaluating fresh init")
    results = test(cfg, model, max_batches=args.max_eval_batches)
    print("RESULTS:", {k: round(v, 4) for k, v in sorted(results.items())})
    return results


if __name__ == "__main__":
    main()
