"""The param model's plain reference (`reference/param.py`) against the port
on the CPU, on one thread, at bench_tiny's cut of `r50_param.train_b16`
(R-50 at 64 px, 16x16 heatmaps, 5 joints, K=8, batch 2) on the seed's
weights: the first heatmaps, the first gradients and the state after three
adam steps; the reference's re-normalized locations against the port's
uncorrected ones; the weight rules; the bound of a call; the readers of the
pooled attention's brackets on a made-up trace; the tiny cell through
`run_cell` in a copy of the benchmark, correct, leaving every file of the
copy as it was; and not correct with each of three faults planted in the
port at run time (the pairs averaged, the corrected normalization, no
`g`).

Both sides compute in float32: the reference rounds every convolution
and BatchNorm to float32 (`model.Conv`, `model.BN`), whatever its input's
dtype, so no float64 comparison of the whole model exists.  The test
imports the port; the reference does not."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.trainer import make_train_step
from epipolar_transformers_tpu_torch.models import epipolar as port_epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention as port_attention
from epipolar_transformers_tpu_torch.ops.epipolar_sampling import (EpipolarGeometry,
                                                                   epipolar_sample_locs)
from h100_bench.harness import brackets, compare, inputs, run_cell, spec, train, weights
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace
from h100_bench.reference import geometry as refgeo
from h100_bench.reference import param
from h100_bench.tests.bench_tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "r50_param.train_b16"
SEED = 2 ** 31 + 23


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny():
    cell = tiny_cell(CELL)
    state = train.reference_state(cell, SEED, "cpu")
    rig = inputs.Rig(cell.traffic, cell.recipe, SEED, "cpu")
    return cell, state, inputs.train_batches(rig, 2, 3)


def test_the_cell_names_the_param_reference():
    cell = spec.load_cell(CELL)
    assert cell.reference is param
    e = cell.recipe["EPIPOLAR"]
    assert (e["POOLING"], e["BOTTLENECK"], e["ZRESIDUAL"], e["USE_CORRECT_NORMALIZE"]) == \
        (True, 2, False, False)
    assert set(e["PARAMETERIZED"]) == {"z", "theta", "phi", "g"}
    assert cell.recipe["KEYPOINT"]["NUM_PTS"] == 20


def test_train_steps_match_the_port(tiny, one_thread):
    cell, state, batches = tiny
    cfg, port = train.build_program(cell.recipe, state, "cpu")
    assert port.reference.epipolar_sampler.route == "streaming"
    port.train()
    optimizer = make_optimizer(cfg, port, 1000)
    step = make_train_step(cfg, port, optimizer)
    program = compare.TrainReading()
    names = {id(p): n[len(compare.PREFIX):] for n, p in port.named_parameters()}
    heads = []
    hook = port.reference.final_layer.register_forward_hook(
        lambda module, args, output: heads.append(output.detach()))
    for i in range(3):
        program.losses.append(float(step(batches[i])["loss"]))
        if i == 0:
            hook.remove()
            program.heatmaps1 = heads[0]
            program.grad_norms = {names[id(p)]: float(s["exp_avg"].norm()) / (1 - compare.B1)
                                  for p, s in optimizer.inner.state.items()}
    now = port.state_dict()
    program.change_norms = {n: float((now[compare.PREFIX + n] - v).norm())
                            for n, v in state.items() if v.is_floating_point()}
    ref = compare.reference_steps(cell, state, batches, "cpu", "float32",
                                  float(cell.recipe["SOLVER"]["BASE_LR"]))
    gaps = compare.train_numbers(program, ref)
    # float32 on both sides, the same weights and inputs; the port computes
    # its sample locations and bilinear weights in float32 where the
    # reference takes the harness's float64 locations, which moves the
    # heatmaps and the gradients by ~1e-5 of their norms, and adam turns
    # gradients near zero into steps of +-lr, whose signs rounding decides,
    # so the later losses and the change after three steps move by a few
    # 1e-3.  Three seeds read at most: loss1 5.4e-7, heatmaps 1.5e-5, median
    # leaf 5.7e-5, worst leaf 1.6e-3, losses 5.8e-3, change 2.4e-3
    assert gaps["loss1_gap"] < 1e-5, gaps
    assert gaps["heatmap1_gap"] < 1e-4, gaps
    assert gaps["grad_median_gap"] < 1e-3 and gaps["grad_gap"] < 1e-2, gaps
    assert gaps["loss_gap"] < 2e-2 and gaps["change_gap"] < 2e-2, gaps


def test_the_locations_follow_the_recipes_normalization(tiny):
    cell, _, batches = tiny
    z = cell.sizes
    b = batches[1]
    geom = EpipolarGeometry(feat_h=z.heatmap_hw[0], feat_w=z.heatmap_hw[1],
                            sample_size=z.samples, downsample=z.stride, resize=1.0,
                            correct_normalize=False)
    got = epipolar_sample_locs(b["KRT"], b["other_KRT"], geom)
    harness = refgeo.sample_locations(b["KRT"], b["other_KRT"], z.heatmap_hw, z.samples,
                                      z.stride, out_dtype=torch.float64)
    want = param.published(harness)
    # the port clips the lines in float32, the reference in float64: the
    # crops of 1000 px frames put up to 2e-4 between them here, where the
    # other normalization would put 1 / 16 (the last assertion)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-3)
    corrected = refgeo.sample_locations(b["KRT"], b["other_KRT"], z.heatmap_hw, z.samples,
                                        z.stride, out_dtype=torch.float64)
    inside = want.abs().amax(-1) < 1.0
    assert inside.any() and (want - corrected)[inside].abs().amax() > 2e-2  # not the same map


def test_the_weight_rules():
    recipe = spec.load_cell(CELL).recipe
    state = weights.make_state(param.state_shapes(recipe), SEED, "cpu", **param.weight_rules)
    for name in ("theta", "phi", "g"):  # gain 1, fan-in 256
        w = state[f"epipolar_sampler.{name}.weight"]
        assert w.shape == (128, 256, 1, 1)
        assert abs(float(w.std()) / (1 / 256) ** 0.5 - 1) < 0.05
    z = state["epipolar_sampler.z.weight"]
    assert z.shape == (256, 128, 1, 1) and abs(float(z.std()) / (1 / 128) ** 0.5 - 1) < 0.05
    bn = state["epipolar_sampler.bn.weight"]  # no residual branch: the default scale
    assert abs(float(bn.mean()) - 1.0) < 0.05 and 0.05 < float(bn.std()) < 0.15
    assert abs(float(state["layer1.0.bn3.weight"].mean()) - 0.25) < 0.05
    assert state["final_layer.weight"].shape == (20, 256, 1, 1)


def test_the_bound_of_a_call(tiny):
    cell, _, batches = tiny
    z = cell.sizes
    locs = refgeo.sample_locations(batches[0]["KRT"], batches[0]["other_KRT"], z.heatmap_hw,
                                   z.samples, z.stride)
    fwd = param.attention_bound(locs, cell.recipe, "bfloat16", backward=False)
    bwd = param.attention_bound(locs, cell.recipe, "bfloat16", backward=True)
    B, K, H, W, _ = locs.shape
    dense = 2 * B * H * W * (K // 2) * 128
    assert 3 * dense < fwd["flops"] < bwd["flops"] and fwd["bytes"] < bwd["bytes"]
    for b in (fwd, bwd):
        assert b["seconds"] == max(b["flops"] / 989e12, b["bytes"] / 3.35e12)
    flops = param.forward_flops(cell.recipe)
    assert flops > 2 * dense  # the convolutions and the two einsums


def _trace(ops, start=0.0, end=10.0):
    """A Trace of (t0, t1, name) kernels."""
    ops = sorted(ops)
    return Trace(device=ops, spans=[], start=start, end=end, kernels=ops)


def _record(trace, steps, bound):
    return RunRecord(kind="train", setup_s=1.0, window_s=10.0, steps=steps, items_per_step=2,
                     peak_window_bytes=0, forward_flops_per_item=1.0, peak_flops=1.0,
                     trace=trace, traced_steps=steps, attention_bound_s=bound)


def test_the_readers_take_the_brackets_of_each_phase(monkeypatch):
    m = brackets.MARKS
    ops = [(0.5, 0.6, m["backward"][1]),  # the end of a step before the traced part
           (1.0, 1.1, "conv"), (1.1, 1.2, m["forward"][0]), (1.2, 1.6, "gather"),
           (1.6, 1.7, m["forward"][1]), (1.7, 2.0, "conv"), (2.0, 2.1, m["backward"][0]),
           (2.1, 2.4, "indexing_backward"), (2.5, 2.9, "sort"), (2.9, 3.0, m["backward"][1]),
           (3.0, 3.5, "adam"), (3.6, 3.7, m["forward"][0]), (3.7, 3.9, "gather")]
    run = _record(_trace(ops), 2, {"forward": 0.2, "backward": 0.4})
    found = brackets.brackets(run.trace)
    assert found == {"forward": [(1.2, 1.6)], "backward": [(2.1, 2.9)]}
    busy = run.trace.busy_s()
    assert brackets.busy_inside(run.trace, [(1.2, 1.6), (2.1, 2.9)]) == pytest.approx(1.1)
    share = spec.reader("pooled_attn_share.train").read(run)
    assert share == pytest.approx(100 * 1.1 / busy)
    roofline = spec.reader("pooled_attn_roofline.train").read(run)
    assert roofline == pytest.approx(100 * (0.2 / 2 + 0.4 / 2) / 1.1)
    # a traced part without a whole bracket of each phase fails the run
    empty = _record(_trace([(1.0, 1.1, "conv"), (1.2, 1.3, m["forward"][0])]), 2,
                    {"forward": 0.2, "backward": 0.4})
    for name in ("pooled_attn_share.train", "pooled_attn_roofline.train"):
        with pytest.raises(RuntimeError):
            spec.reader(name).read(empty)
    # a program without the marks gives no reading
    monkeypatch.setattr(brackets, "program_marks", lambda: False)
    for name in ("pooled_attn_share.train", "pooled_attn_roofline.train"):
        assert spec.reader(name).read(empty) is None


def test_the_port_has_the_marks():
    assert brackets.program_marks()


RUN = f'''
import json
import torch
import h100_bench
from h100_bench.harness import run_cell
from h100_bench.tests.bench_tiny import tiny_cell
cell = tiny_cell("{CELL}")
result = run_cell(cell, {SEED}, 0.2, False, torch.device("cpu"), 0.0)
print(json.dumps({{"correct": result["correct"], "checks": result["checks"],
                  "reference": cell.reference.__name__, "bench": h100_bench.__file__}}))
'''


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_the_tiny_cell_runs_correct_and_leaves_the_files(tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(ROOT / "h100_bench", bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert Path(got["bench"]).resolve().is_relative_to(tmp_path.resolve())
    assert got["reference"] == "h100_bench.reference.param"
    assert got["correct"] is True, got["checks"]
    assert _digests(tmp_path) == before


def averaged_pairs(monkeypatch):
    real = port_attention.sample_stack

    def stack(image, locs, H, W, pooling):
        out = real(image, locs, H, W, False)
        half = locs.shape[1] // 2
        return (out[:, :half] + out[:, half:]) / 2 if pooling else out

    monkeypatch.setattr(port_attention, "sample_stack", stack)


def corrected_normalization(monkeypatch):
    real = port_epipolar.Epipolar.geometry.fget
    monkeypatch.setattr(port_epipolar.Epipolar, "geometry", property(
        lambda self: real(self)._replace(correct_normalize=True)))


def no_g(monkeypatch):  # the values are the keys
    real = train.build_program

    def build(recipe, state, device):
        cfg, model = real(recipe, state, device)
        fusion = model.reference.epipolar_sampler
        fusion.g = fusion.phi
        return cfg, model

    monkeypatch.setattr(train, "build_program", build)


@pytest.mark.parametrize("fault", [averaged_pairs, corrected_normalization, no_g])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(tiny_cell(CELL), SEED, 0.2, False, torch.device("cpu"), 0.0)
    assert result["correct"] is False, result["checks"]
