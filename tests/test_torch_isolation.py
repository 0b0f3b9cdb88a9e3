"""The port imports neither JAX, flax nor anything of the JAX package.

A fresh interpreter with `sys.modules[name] = None` for `jax`, `flax` and
`epipolar_transformers_tpu` (so any import of one raises) imports every
module of the port and `chip_smoke.py`, runs the tiny flagship slice on the
CPU through `engine.tester.predict`, one tiny train step through
`engine.trainer.train`, the eval engine `engine.test` (pymvg, two groups)
and the port's command line (one train step, then one eval group); no
module of the three is loaded at the end.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "epipolar_transformers_tpu")
for name in BLOCKED:
    sys.modules[name] = None
import torch
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
