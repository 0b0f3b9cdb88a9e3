"""The comparison that decides `correct`, with the timed path broken
underneath: each cell's run, at a size a CPU test holds and past the
harness's look for a card, comes out not correct under the cell's own
limits once for each fault that the cell can have, and correct when sound.
And the control (the reference one precision below the configuration's,
in the program's place) fails at least one of the cell's limits."""

import numpy as np
import pytest
import torch

from h100_bench.harness import compare, infer, inputs, run_cell, spec, train
from h100_bench.tests.bench_tiny import tiny_cell

TRAIN = "r50_256.train_b16"
INFER = "r50_256.infer_group"
SEED = 2 ** 31 + 17


def _run(cell):
    return run_cell(cell, SEED, 0.2, False, torch.device("cpu"), 0.0)


REAL_TRAIN_STEP = train.make_train_step
REAL_PROCESS_GROUP = infer.process_group
REAL_EVAL_STEP = infer.make_eval_step


def unchanged_state(cfg, model, optimizer):
    """A step that leaves the model's state as it was."""
    step = REAL_TRAIN_STEP(cfg, model, optimizer)

    def broken(inputs):
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        out = step(inputs)
        model.load_state_dict(saved)
        optimizer.inner.state.clear()
        return out

    return broken


def half_batch(cfg, model, optimizer):
    """A step on the first half of the batch, its mean over that half."""
    step = REAL_TRAIN_STEP(cfg, model, optimizer)
    return lambda inputs: step({k: v[: len(v) // 2] for k, v in inputs.items()})


def test_a_sound_train_run_is_correct():
    result = _run(tiny_cell(TRAIN))
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(train, "make_train_step", fault)
    result = _run(tiny_cell(TRAIN))
    assert result["correct"] is False, result["checks"]


def test_a_sound_infer_run_is_correct():
    result = _run(tiny_cell(INFER))
    assert result["correct"] is True, result["checks"]


def _alter_pose(cfg, group, out, record, ib=0, device=None):
    metrics = REAL_PROCESS_GROUP(cfg, group, out, record, ib, device)
    record.predictions[-1]["pred3d"] = record.predictions[-1]["pred3d"] + np.array([5.0, 0, 0])
    return metrics


def _alter_keypoint(cfg, group, out, record, ib=0, device=None):
    out = {**out, "batch_locs": out["batch_locs"] + np.array([1.0, 0.0])}
    return REAL_PROCESS_GROUP(cfg, group, out, record, ib, device)


def _alter_heatmaps(cfg, model, device, train_bn=False):
    step = REAL_EVAL_STEP(cfg, model, device, train_bn)

    def broken(group):
        out = step(group)
        return {**out, "heatmap_pred": out["heatmap_pred"] * 1.5}

    return broken


@pytest.mark.parametrize("name, fault", [("process_group", _alter_pose),
                                         ("process_group", _alter_keypoint),
                                         ("make_eval_step", _alter_heatmaps)])
def test_an_altered_answer_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(infer, name, fault)
    result = _run(tiny_cell(INFER))
    assert result["correct"] is False, result["checks"]


def test_the_infer_control_fails_a_limit():
    """At a CPU test's size: the reference one precision below the
    configuration's, put in the program's place, fails the heatmaps' limit."""
    cell = tiny_cell(INFER, dtype="bfloat16")
    state = train.reference_state(cell, SEED, "cpu")
    rig = inputs.Rig(cell.traffic, cell.recipe, SEED, "cpu")
    groups = inputs.infer_groups(rig, 2)
    ref = compare.infer_reference_heatmaps(cell, state, groups, "cpu", "float32")
    low = compare.infer_reference_heatmaps(cell, state, groups, "cpu",
                                           cell.config["control_precision"])
    gap = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(low, ref))
    assert gap > cell.limits["heatmap_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [TRAIN, "r152_384.train_b8", INFER])
def test_the_control_fails_a_limit_on_the_card(name):
    """On the card, at the cell's own size (`control.py`, three seeds): the
    control fails at least one of the cell's limits on every seed, and so
    does a train step on half of each batch."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "h100_bench/control.py", "--workload", name,
                          "--seeds", "7", "8", "9"], cwd=root, capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = spec.load_cell(name).limits
    for line in out.stdout.splitlines():
        reading = json.loads(line)
        for kind in ("control", "half_batch"):
            if kind in reading:
                assert not compare.all_within(compare.judge(reading[kind], limits)), reading
