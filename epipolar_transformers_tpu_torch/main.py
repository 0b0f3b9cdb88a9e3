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

Not ported yet, each raising when asked: VIS.FLOPS, the visualization
dispatch and `--trace` (ROADMAP A13).
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
                        help="profiler trace of the run (ROADMAP A13; raises)")
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

    if args.trace:
        raise NotImplementedError("--trace (a profiler trace of the run) is ROADMAP A13 "
                                  "in the port")
    if cfg.VIS.FLOPS:
        raise NotImplementedError("VIS.FLOPS (the parameter and FLOP count) is ROADMAP A13 "
                                  "in the port")
    if _wants_visualization(cfg):
        raise NotImplementedError("the VIS dispatch (pointcloud, AUC, video, epipolar lines, "
                                  "cursor) is ROADMAP A13 in the port")
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
