#!/usr/bin/env python3
"""Why a random R-152 file without zero-init residuals gives MPJPE NaN.

    python3 scripts/torch_r152_eval_nan.py [--batch 2] [--threads 4]

Runs on the CPU (about a minute and a few GiB).  Writes a small fake H36M
tree and chip_smoke.py's seeded torchvision-layout R-152 file into a
temporary directory, twice: with every BN weight near 1, and with the last
BN of each block near 0 (`zero_init_residual`, what chip_smoke.py writes).
For each, configs/epipolar/keypoint_h36m_resnet152_320_fixed_8gpu.yaml as
written (320 px, 80x80) but at `--batch` items and no loader workers takes
one train step, then evaluates its first validation group.  Prints, per
file:

  - the largest |activation| out of the trunk (layer4) at eval;
  - the heatmap peaks (`score_pred`) over the group's views and joints,
    and how far an f64 eval of the same weights lies from the f32 one
    (relative to the largest peak): the growth is the weights', not f32
    rounding or overflow;
  - the joints whose every view peaks at or below -1, where the pymvg
    triangulation's adaptive threshold stops at -1 with fewer than two
    views (tests/test_torch_triangulation.py holds the JAX package's
    `triangulate_pymvg_np` to the same NaN), and the joints it returns
    as NaN;
  - the group's MPJPE.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
RECIPE = ROOT / "configs/epipolar/keypoint_h36m_resnet152_320_fixed_8gpu.yaml"


def evaluate(model, cfg, loader_group):
    """The eval forward of one view group, with layer4's largest output."""
    from epipolar_transformers_tpu_torch.engine.tester import make_eval_step

    trunk = next(m for m in model.modules() if hasattr(m, "layer4"))
    seen = []
    hook = trunk.layer4.register_forward_hook(
        lambda m, i, o: seen.append(float(o.abs().max())))
    try:
        out = make_eval_step(cfg, model, "cpu")(loader_group)
    finally:
        hook.remove()
    return out, max(seen)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from epipolar_transformers_tpu_torch.config import load_config
    from epipolar_transformers_tpu_torch.data.pipeline import make_eval_loaders
    from epipolar_transformers_tpu_torch.engine.tester import EvalRecord, process_group
    from epipolar_transformers_tpu_torch.engine.trainer import train
    from epipolar_transformers_tpu_torch.geometry.host import triangulate_pymvg_np

    torch.set_num_threads(args.threads)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_fake_h36m(os.path.join(tmp, "datasets"), 4, 2, 400)
        os.chdir(tmp)  # the recipe names its datasets/ relative to here
        for zero_init in (False, True):
            chip_smoke.write_torchvision_resnet(chip_smoke.R152_WEIGHTS, 152,
                                                zero_init_residual=zero_init)
            cfg = load_config(str(RECIPE), [
                "SOLVER.IMS_PER_BATCH", str(args.batch), "DATALOADER.NUM_WORKERS", "0",
                "OUTPUT_DIR", os.path.join(tmp, f"out{int(zero_init)}")])
            model, _ = train(cfg, max_steps=1, device="cpu")
            batch = next(iter(make_eval_loaders(cfg)[0]))
            group = {k: v[0] for k, v in batch.items()}
            out, trunk_max = evaluate(model, cfg, group)
            wide = copy.deepcopy(model).double()
            for m in wide.modules():
                if hasattr(m, "compute_dtype"):
                    m.compute_dtype = torch.float64
            out64, _ = evaluate(wide, cfg, group)
            scores = out["score_pred"].double().numpy()  # (views, joints)
            f64_gap = float((out["heatmap_pred"].double() - out64["heatmap_pred"]).abs().max()
                            / out64["score_pred"].abs().max())
            record = EvalRecord()
            host = {k: v.numpy() for k, v in out.items()}
            metrics = process_group(cfg, group, host, record)
            pred = triangulate_pymvg_np(host["batch_locs"] * cfg.DATASETS.IMAGE_RESIZE
                                        * cfg.DATASETS.PREDICT_RESIZE, group["K"], group["RT"],
                                        scores, conf_thres=cfg.KEYPOINT.CONF_THRES)
            print(f"zero_init_residual {zero_init}: layer4 max |x| {trunk_max:.4g}; heatmap "
                  f"peaks {scores.min():.6g} .. {scores.max():.6g}; f64 against f32 "
                  f"{f64_gap:.3g} of the largest peak; joints with every view at or below -1 "
                  f"{np.nonzero((scores <= -1).all(axis=0))[0].tolist()}; NaN joints "
                  f"{np.nonzero(np.isnan(pred).any(axis=-1))[0].tolist()}; MPJPE "
                  f"{metrics['EPEmean_global']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
