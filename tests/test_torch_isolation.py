"""The port imports neither JAX, flax nor anything of the JAX package, and
its RHD and H36M paths neither cv2 nor PIL.

A fresh interpreter with `sys.modules[name] = None` for `jax`, `flax`,
`epipolar_transformers_tpu`, `cv2` and `PIL` (so any import of one raises)
imports every
module of the port and `chip_smoke.py`, runs the tiny flagship slice on the
CPU through `engine.tester.predict`, one tiny train step through
`engine.trainer.train`, the eval engine `engine.test` (pymvg, two groups),
the port's command line (one train step, then one eval group), a train
step of the epipolarHG1 recipe (cut to NFEATS 32, batch 2), a tiny train
step from DATALOADER.DEVICE_RENDER batches, a tiny train step with the
learned EPIPOLAR.PRIOR table, a train step of the param recipe (pooled,
cut to 64 px, K=8, batch 2), the import of a reference-format `.pth`,
configs/lifting/lifting_rot.yaml through the command line on a fake RHD
tree (a lifting train step, then `_test_lifting`) and the single-view
`keypoint` task (a train step, then `test` under pymvg), and the H36M path
on a fake tree that chip_smoke.write_fake_h36m writes with the port's JPEG
encoder (an item, a train loader with 2 worker processes, and
configs/epipolar/fake_h36m_zresidual.yaml through the command line, cut to
a tiny width), and the command line with --multihost on two gloo ranks
(processes spawned with the same modules blocked; a train step, then rank
0's eval); no blocked module is loaded at the end.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "epipolar_transformers_tpu", "cv2", "PIL")
for name in BLOCKED:
    sys.modules[name] = None
import torch
torch.set_num_threads(1)  # one process among the suite's workers
import epipolar_transformers_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader
from epipolar_transformers_tpu_torch.engine.tester import predict
from epipolar_transformers_tpu_torch.models import ModelBuilder
torch.manual_seed(0)
cfg = flagship_cfg(tiny=True)
outs = predict(cfg, ModelBuilder(cfg), EvalLoader(SyntheticMultiview(cfg, False, 2)))
assert len(outs) == 2
for out in outs:
    assert out["heatmap_pred"].shape == (4, 5, 8, 8), out["heatmap_pred"].shape
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
import tempfile
from epipolar_transformers_tpu_torch.engine.trainer import train
with tempfile.TemporaryDirectory() as out_dir:
    model, optimizer = train(cfg.replace(OUTPUT_DIR=out_dir), max_steps=1, device="cpu")
assert optimizer.count == 1 and all(bool(torch.isfinite(p).all()) for p in model.parameters())
import math
from epipolar_transformers_tpu_torch.config import update_from_dict
from epipolar_transformers_tpu_torch.engine import test
results = test(update_from_dict(cfg, {"KEYPOINT": {"TRIANGULATION": "pymvg"},
                                      "TEST": {"IMS_PER_BATCH": 1}}), model, max_batches=2)
assert math.isfinite(results["EPEmean_global"]) and "PCK@1" in results, results
from epipolar_transformers_tpu_torch.main import main
with tempfile.TemporaryDirectory() as out_dir:
    results = main(["--cfg", "configs/epipolar/synthetic_zresidual.yaml", "--device", "cpu",
                    "--max-steps", "1", "--max-eval-batches", "1", "OUTPUT_DIR", out_dir])
assert math.isfinite(results["EPEmean_global"]), results
from epipolar_transformers_tpu_torch.config import load_config
hg = update_from_dict(load_config("configs/epipolar/synthetic_hg.yaml"), {
    "KEYPOINT": {"NFEATS": 32}, "SOLVER": {"IMS_PER_BATCH": 2},
    "DATALOADER": {"DEVICE_RENDER": False}})
rendered = update_from_dict(cfg, {"DATALOADER": {"DEVICE_RENDER": True}})
for c in (hg, rendered):
    with tempfile.TemporaryDirectory() as out_dir:
        model, optimizer = train(c.replace(OUTPUT_DIR=out_dir), max_steps=1, device="cpu")
    assert optimizer.count == 1 and all(bool(torch.isfinite(p).all()) for p in model.parameters())
from epipolar_transformers_tpu_torch.engine.trainer import build_model, load_weights
with tempfile.TemporaryDirectory() as out_dir:
    path = out_dir + "/reference.pth"
    torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}}, path)
    imported = build_model(cfg.replace(SEED=1, WEIGHTS=path), torch.device("cpu"))
    load_weights(cfg.replace(WEIGHTS=path), imported)
assert torch.equal(imported.reference.conv1.weight, model.reference.conv1.weight)
prior = update_from_dict(cfg, {"EPIPOLAR": {"PRIOR": True}, "DATASETS": {"CAMERAS": (0, 1, 2, 3)}})
param = update_from_dict(load_config("configs/epipolar/keypoint_h36m_param.yaml"), {
    "DATASETS": {"TRAIN": ("synthetic_multiview_train",), "TEST": ("synthetic_multiview_val",),
                 "IMAGE_SIZE": (64, 64)},
    "BACKBONE": {"PRETRAINED": False}, "KEYPOINT": {"NUM_PTS": 17, "HEATMAP_SIZE": (16, 16)},
    "EPIPOLAR": {"SAMPLESIZE": 8}, "SOLVER": {"IMS_PER_BATCH": 2}})
for c, route in ((prior, "kernel"), (param, "streaming")):
    with tempfile.TemporaryDirectory() as out_dir:
        model, optimizer = train(c.replace(OUTPUT_DIR=out_dir), max_steps=1, device="cpu")
    assert optimizer.count == 1 and all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert model.reference.epipolar_sampler.route == route
from chip_smoke import write_fake_rhd
from epipolar_transformers_tpu_torch.config import DatasetCatalog
with tempfile.TemporaryDirectory() as data_dir:
    write_fake_rhd(data_dir, n_items=2)
    DatasetCatalog.DATA_DIR = data_dir
    results = main(["--cfg", "configs/lifting/lifting_rot.yaml", "--device", "cpu",
                    "--max-steps", "1", "--max-eval-batches", "1", "SOLVER.IMS_PER_BATCH", "2",
                    "TEST.IMS_PER_BATCH", "2", "OUTPUT_DIR", data_dir + "/out"])
assert math.isfinite(results["EPEmean"]) and math.isfinite(results["EPEmean_can"]), results
keypoint = update_from_dict(cfg, {"DATASETS": {"TASK": "keypoint"},
                                  "BACKBONE": {"BODY": "poseR-18"},
                                  "KEYPOINT": {"TRIANGULATION": "pymvg"},
                                  "TEST": {"IMS_PER_BATCH": 1}})
with tempfile.TemporaryDirectory() as out_dir:
    model, optimizer = train(keypoint.replace(OUTPUT_DIR=out_dir), max_steps=1, device="cpu")
assert optimizer.count == 1
results = test(keypoint, model, max_batches=1)
assert math.isfinite(results["EPEmean_global"]), results
from chip_smoke import write_fake_h36m
from epipolar_transformers_tpu_torch.data.datasets.multiview_h36m import MultiViewH36M
from epipolar_transformers_tpu_torch.data.pipeline import TrainLoader
with tempfile.TemporaryDirectory() as data_dir:
    write_fake_h36m(data_dir, train_groups=2, val_groups=1, image_size=64)
    h36m = update_from_dict(cfg, {"DATASETS": {"DATA_FORMAT": "zip", "H36M": {"MAPPING": False,
                                                                          "TRAIN_SAMPLE": 0}},
                                  "KEYPOINT": {"NUM_PTS": 17}})
    ds = MultiViewH36M(h36m, data_dir, data_dir + "/h36m/annot/h36m_train.pkl", True)
    assert ds[0]["img"].shape == (32, 32, 3)
    batches = list(TrainLoader(ds, batch_size=1, seed=0, num_workers=2))
    assert len(batches) == 2 and batches[1]["other_img"].shape == (1, 32, 32, 3)
    DatasetCatalog.DATA_DIR = data_dir
    results = main(["--cfg", "configs/epipolar/fake_h36m_zresidual.yaml", "--device", "cpu",
                    "--max-steps", "1", "--max-eval-batches", "1",
                    "BACKBONE.BODY", "epipolarposeR-18", "DATASETS.IMAGE_SIZE", "(32, 32)",
                    "KEYPOINT.HEATMAP_SIZE", "(8, 8)", "EPIPOLAR.SAMPLESIZE", "4",
                    "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "2",
                    "OUTPUT_DIR", data_dir + "/out"])
assert math.isfinite(results["EPEmean_global"]), results
sys.path.insert(0, "tests")
from torch_ddp_ranks import run_ranks
with tempfile.TemporaryDirectory() as tmp:
    ranks = run_ranks("cli_rank", 2, tmp, [
        "--multihost", "--device", "cpu", "--cfg", "configs/epipolar/synthetic_zresidual.yaml",
        "--max-steps", "1", "--max-eval-batches", "1", "OUTPUT_DIR", tmp + "/out"], BLOCKED)
assert math.isfinite(ranks[0]["results"]["EPEmean_global"]) and ranks[1]["results"] is None
assert not ranks[0]["loaded"] and not ranks[1]["loaded"], ranks
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ISOLATED_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED_OK" in proc.stdout
