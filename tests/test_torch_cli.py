"""The port's command line (`python -m epipolar_transformers_tpu_torch.main`)
on the tiny flagship, written as a YAML file (epipolarposeR-18, 32 px, 8x8
heatmaps, 5 joints, K=4, f32; pymvg triangulation), on the CPU: train and
eval dispatch with `eval_fn` every EVAL_FREQ epochs, the `RESULTS:` line,
the eval-only branch restoring `last_checkpoint`, the GPU default, and
what raises.  The train set is the synthetic rig cut to 8 items, one step
of 8 an epoch.
"""

import ast
import logging
import math

import pytest
import torch

from epipolar_transformers_tpu_torch import main as cli
from epipolar_transformers_tpu_torch.config import DatasetCatalog, flagship_cfg, load_config
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

TRAIN_SET = "synthetic_multiview_train_8"
TINY_FLAGSHIP_YAML = f"""\
DATASETS:
    TRAIN: ('{TRAIN_SET}',)
    TEST: ('synthetic_multiview_val',)
    TASK: multiview_keypoint
    IMAGE_SIZE: (32, 32)
    IMAGE_RESIZE: 1.
    PREDICT_RESIZE: 1.
BACKBONE:
    ENABLED: True
    BODY: epipolarposeR-18
    PRETRAINED: False
    DOWNSAMPLE: 4
KEYPOINT:
    ENABLED: True
    NUM_PTS: 5
    HEATMAP_SIZE: (8, 8)
    SIGMA: 2.
    NFEATS: 256
    LOSS: joint
    LOSS_PER_JOINT: False
    TRIANGULATION: pymvg
EPIPOLAR:
    SAMPLESIZE: 4
    MERGE: late
    ATTENTION: avg
    SIMILARITY: dot
    PARAMETERIZED: ('z',)
    ZRESIDUAL: True
    SHARE_WEIGHTS: True
    PRETRAINED: False
    USE_CORRECT_NORMALIZE: True
SOLVER:
    OPTIMIZER: adam
    BASE_LR: 0.001
    IMS_PER_BATCH: 8
    MAX_EPOCHS: 2
    CHECKPOINT_PERIOD: 1
TEST:
    IMS_PER_BATCH: 1
TENSORBOARD:
    USE: False
LOG_FREQ: 1
"""


@pytest.fixture
def yaml_path(tmp_path, monkeypatch):
    monkeypatch.setitem(DatasetCatalog.DATASETS, TRAIN_SET, {
        "factory": "SyntheticMultiview", "is_train": True, "n_samples": 8})
    path = tmp_path / "tiny_flagship.yaml"
    path.write_text(TINY_FLAGSHIP_YAML)
    return str(path)


@pytest.fixture
def evaluated(monkeypatch):
    """Every model the CLI evaluates, in order (the real `test` still runs)."""
    calls = []

    def spy(cfg, model, max_batches=None):
        calls.append(model)
        return run_test(cfg, model, max_batches=max_batches)

    run_test = cli.test
    monkeypatch.setattr(cli, "test", spy)
    return calls


def _results(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULTS: ")]
    assert len(lines) == 1, out[-2000:]
    return ast.literal_eval(lines[0][len("RESULTS: "):])


def test_yaml_is_the_tiny_flagship(yaml_path):
    cfg, flagship = load_config(yaml_path), flagship_cfg(tiny=True)
    for node in ("BACKBONE", "EPIPOLAR"):
        assert getattr(cfg, node) == getattr(flagship, node)
    assert cfg.KEYPOINT == flagship.KEYPOINT.replace(TRIANGULATION="pymvg")


@pytest.mark.parametrize("max_steps,eval_freq,evals", [
    (1, 1, 0),      # the step cap returns inside the first epoch, as in JAX
    (None, 1, 2),
    (None, 2, 1),
    (None, 0, 0),   # EVAL_FREQ <= 0: no periodic eval
])
def test_cli_trains_evaluates_and_prints_results(yaml_path, tmp_path, evaluated, capsys,
                                                 max_steps, eval_freq, evals):
    argv = ["--cfg", yaml_path, "--device", "cpu", "--max-eval-batches", "1"]
    if max_steps is not None:
        argv += ["--max-steps", str(max_steps)]
    results = cli.main(argv + ["EVAL_FREQ", str(eval_freq), "OUTPUT_DIR", str(tmp_path / "out")])
    assert len(evaluated) == evals + 1  # the periodic evals, then DOTEST
    printed = _results(capsys.readouterr().out)
    assert set(printed) == set(results)
    assert {"EPEmean_global", "MPJPE@action0", "JDR", "PCK@1"} <= set(printed)
    assert all(math.isfinite(v) for v in printed.values())
    assert all(next(m.parameters()).device.type == "cpu" for m in evaluated)


def test_cli_eval_only_loads_last_checkpoint(yaml_path, tmp_path, evaluated, caplog):
    out = str(tmp_path / "out")
    cfg = load_config(yaml_path, ["SEED", "1"])
    saved = trainer.build_model(cfg, torch.device("cpu"))
    Checkpointer(out).save("model_001", saved)
    with caplog.at_level(logging.WARNING):
        cli.main(["--cfg", yaml_path, "--device", "cpu", "--max-eval-batches", "1",
                  "DOTRAIN", "False", "OUTPUT_DIR", out])
    assert "fresh init" not in caplog.text
    (model,) = evaluated
    for (k, a), b in zip(saved.state_dict().items(), model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    with caplog.at_level(logging.WARNING):
        cli.main(["--cfg", yaml_path, "--device", "cpu", "--max-eval-batches", "1",
                  "DOTRAIN", "False", "OUTPUT_DIR", str(tmp_path / "empty")])
    assert "no checkpoint found; evaluating fresh init" in caplog.text


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(yaml_path, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer.torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    for device in ([], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no GPU"):
            cli.main(["--cfg", yaml_path, *device, "OUTPUT_DIR", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("argv,error,match", [
    # --multihost is ported: outside torchrun it raises for the missing
    # environment (tests/test_torch_parallel.py runs it under a group)
    (["--multihost"], RuntimeError, "torchrun's environment"),
    # the VIS dispatch is ported: POINTCLOUD without a predictions pickle
    # raises as the JAX dispatch does (tests/test_torch_vis_cli.py runs the
    # modes)
    (["VIS.POINTCLOUD", "True", "DOTRAIN", "False", "DOTEST", "False"], FileNotFoundError,
     "predictions"),
], ids=["multihost", "vis"])
def test_cli_unported_options_raise(yaml_path, tmp_path, monkeypatch, argv, error, match):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    flags = [a for a in argv if a.startswith("--") or a == "t"]
    opts = [a for a in argv if a not in flags]
    with pytest.raises(error, match=match):
        cli.main(["--cfg", yaml_path, "--device", "cpu", *flags, *opts,
                  "OUTPUT_DIR", str(tmp_path)])
