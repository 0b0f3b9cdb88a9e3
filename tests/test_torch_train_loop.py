"""The port's `engine.trainer.train` on the tiny flagship config, on the
CPU: the loop, the checkpoints and the `last_checkpoint` resume (the
counterpart of tests/test_train_loop.py for the JAX package, small enough
for tier 1).  The train set is the synthetic rig cut to 16 items, so one
epoch is 2 steps of 8.  The loop runs on the CPU only when asked to; the
loader's order is the JAX loader's (tests/test_torch_config.py).
"""

import math
import os
import re

import pytest
import torch

from epipolar_transformers_tpu_torch.config import DatasetCatalog, flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.trainer import train
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

TRAIN_SET = "synthetic_multiview_train_16"


@pytest.fixture
def cfg(tmp_path, monkeypatch):
    monkeypatch.setitem(DatasetCatalog.DATASETS, TRAIN_SET, {
        "factory": "SyntheticMultiview", "is_train": True, "n_samples": 16})
    return update_from_dict(flagship_cfg(tiny=True), {
        "DATASETS": {"TRAIN": (TRAIN_SET,)},
        "SOLVER": {"IMS_PER_BATCH": 8, "MAX_EPOCHS": 1, "CHECKPOINT_PERIOD": 1},
        "TENSORBOARD": {"USE": False},
        "LOG_FREQ": 1,
        "OUTPUT_DIR": str(tmp_path),
    })


def test_train_steps_with_finite_loss(cfg, caplog):
    """max_steps stops the loop inside the second epoch, before its
    checkpoint, as the JAX loop does."""
    cfg = cfg.replace(SOLVER=cfg.SOLVER.replace(MAX_EPOCHS=2))
    with caplog.at_level("INFO", logger="epipolar_transformers_tpu_torch.engine.trainer"):
        model, optimizer = train(cfg, max_steps=3, device="cpu")
    losses = [float(m) for m in re.findall(r"\bloss: (\S+)", caplog.text)]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), losses
    assert optimizer.count == 3
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert sorted(os.listdir(cfg.OUTPUT_DIR)) == ["last_checkpoint", "model_000.pth"]


def test_train_checkpoints_and_resumes(cfg):
    model, optimizer = train(cfg, device="cpu")
    assert optimizer.count == 2
    files = set(os.listdir(cfg.OUTPUT_DIR))
    assert {"model_000.pth", "model_final.pth", "last_checkpoint"} <= files
    with open(os.path.join(cfg.OUTPUT_DIR, "last_checkpoint")) as f:
        assert f.read().strip() == "model_final.pth"

    # resume: MAX_EPOCHS is reached, so no step runs and the returned model
    # and optimizer are the checkpoint's
    resumed, resumed_opt = train(cfg, device="cpu")
    assert resumed_opt.count == 2
    for (k, a), b in zip(model.state_dict().items(), resumed.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    # WEIGHTS_LOAD_OPT=False restores the weights and leaves a fresh optimizer
    weights_only, fresh_opt = train(cfg.replace(WEIGHTS_LOAD_OPT=False), device="cpu")
    assert fresh_opt.count == 0
    for (k, a), b in zip(model.state_dict().items(), weights_only.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_train_needs_a_gpu_unless_asked_for_the_cpu(cfg, monkeypatch):
    """Without a device, train() runs on cuda:0 and raises where torch sees
    no GPU, before it builds anything; it never falls back to the CPU."""
    monkeypatch.setattr(trainer.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        train(cfg, max_steps=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        train(cfg, max_steps=1, device="cuda:0")
    assert os.listdir(cfg.OUTPUT_DIR) == []
