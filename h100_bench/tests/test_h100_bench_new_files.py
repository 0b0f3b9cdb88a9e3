"""A new model enters the benchmark as new files and entries alone: in a copy
of the benchmark, a reference module of its own (the flagship's fusion
under another name, counting each call of the contract in
`reference/__init__.py`), a configuration file that names it, a limits
file and `BENCHMARK.json` entries; its cell then runs through `run_cell` at
bench_tiny's cut on the CPU, traced, reaches every function of the
contract through `spec.Cell.reference`, comes out correct, and leaves every
file the copy had as it was."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 41

STUB = '''"""A stand-in reference: the flagship's fusion under a name of its own,
each call of the contract counted in CALLS."""

from collections import Counter

import torch

from ..harness import weights
from . import model

CALLS = Counter()


class StubFusion(model.EpipolarFusion):
    pass


def _model(recipe, precision="float32"):
    return model.PoseResNet(*model.dims(recipe), precision, fusion=StubFusion(256, precision))


def state_shapes(recipe):
    CALLS["state_shapes"] += 1
    with torch.device("meta"):
        m = _model(recipe)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def build(recipe, precision, state, device):
    CALLS["build"] += 1
    with torch.device(device):
        m = _model(recipe, precision)
    m.load_state_dict(state, strict=True)
    return m


def loss(heatmaps, batch):
    CALLS["loss"] += 1
    return model.loss(heatmaps, batch)


def forward_flops(recipe):
    CALLS["forward_flops"] += 1
    with torch.device("meta"):
        m = _model(recipe)
    return model.count_forward_flops(m, recipe)


def attention_bound(locs, recipe, dtype, backward):
    CALLS["attention_bound"] += 1
    return model.attention_bound(locs, recipe, dtype, backward)


def __getattr__(name):  # counts the harness's look for the optional rules
    if name == "weight_rules":
        CALLS["weight_rules"] += 1
        return {"no_relu_after": weights.NO_RELU_AFTER,
                "scaled_branch_bn": weights.SCALED_BRANCH_BN}
    raise AttributeError(name)
'''

RUN = f'''
import json
import torch
import h100_bench
from h100_bench.harness import run_cell
from h100_bench.reference import stub_fusion
from h100_bench.tests.bench_tiny import tiny_cell
cell = tiny_cell("stub_r50.train_b16")
result = run_cell(cell, {SEED}, 0.2, True, torch.device("cpu"), 0.0)
print(json.dumps({{"correct": result["correct"], "checks": result["checks"],
                  "calls": dict(stub_fusion.CALLS), "reference": cell.reference.__name__,
                  "bench": h100_bench.__file__}}))
'''


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_model_runs_from_new_files_alone(tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(bench)
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())

    (bench / "reference" / "stub_fusion.py").write_text(STUB)
    config = json.loads((bench / "configs" / "epipolar_r50_256_bf16.json").read_text())
    config.update(name="stub_r50_256_bf16", reference="stub_fusion")
    (bench / "configs" / "stub_r50_256_bf16.json").write_text(json.dumps(config))
    shutil.copy(bench / "limits" / "r50_256.train_b16.json",
                bench / "limits" / "stub_r50.train_b16.json")
    new = json.loads(json.dumps(old))
    new["configs"].append({**old["configs"][0], "name": "stub_r50_256_bf16",
                           "file": "h100_bench/configs/stub_r50_256_bf16.json"})
    new["workloads"].append({"name": "stub_r50.train_b16", "config": "stub_r50_256_bf16",
                             "traffic": "train_h36m_crops", "chips": 1,
                             "why": "a stand-in model from new files"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert Path(got["bench"]).resolve().is_relative_to(tmp_path.resolve())
    assert got["reference"] == "h100_bench.reference.stub_fusion"
    assert set(got["calls"]) == {"state_shapes", "build", "loss", "forward_flops",
                                 "attention_bound", "weight_rules"}, got["calls"]
    assert got["correct"] is True, got["checks"]

    after = _digests(bench)
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == {"reference/stub_fusion.py",
                                        "configs/stub_r50_256_bf16.json",
                                        "limits/stub_r50.train_b16.json"}
    for key, entries in old.items():  # BENCHMARK.json: entries added, none changed
        kept = new[key][:len(entries)] if isinstance(entries, list) else new[key]
        assert kept == entries, key
