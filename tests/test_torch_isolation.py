"""The port imports neither JAX nor flax.

A fresh interpreter with `sys.modules['jax'] = sys.modules['flax'] = None`
(so any import of either raises) imports every module of the port and runs
the tiny flagship slice on the CPU through `engine.tester.predict`.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
import epipolar_transformers_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import eval_batches
from epipolar_transformers_tpu_torch.engine.tester import predict
from epipolar_transformers_tpu_torch.models import ModelBuilder
torch.manual_seed(0)
cfg = flagship_cfg(tiny=True)
outs = predict(cfg, ModelBuilder(cfg), eval_batches(SyntheticMultiview(cfg, False, 2)))
assert len(outs) == 2
for out in outs:
    assert out["heatmap_pred"].shape == (4, 5, 8, 8), out["heatmap_pred"].shape
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax"))
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
