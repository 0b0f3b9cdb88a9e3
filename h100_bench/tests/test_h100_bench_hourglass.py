"""The stacked hourglass's cell (`hg3_256.train_b16`, reference
`reference/hourglass.py`) on the CPU, at bench_tiny's cut with the
`epipolarHG` body kept (all three stacks), NFEATS 32 and batches of 8: the
tiny cell
through `run_cell` in a copy of the benchmark, correct, leaving every file
of the copy as it was; not correct with each of four faults planted in the
port at run time (the loss on the last stack alone, one stack's fusion
skipped, the upsample without align_corners, BN on its running statistics
in training); the reference's contract (its state against the port's, the
weight rules, the bound of a step's three calls, the FLOPs); and the
`hg_fusion_share.train` reader on made-up traces.

Batches of 8, not bench_tiny's 2: with the loss on the last stack alone the
median leaf's first gradient moves by 0.07-0.14 at 8 (three seeds) and by
0.013-0.045 at 2, under `grad_median_gap`'s limit of 0.05, which the cell
reads 0.111-0.139 at its own size.

The port's own parity with the reference, in float64, is
tests/test_torch_hourglass_h36m.py's.  The test imports the port; the
reference does not."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from epipolar_transformers_tpu_torch.models import builder as port_builder
from epipolar_transformers_tpu_torch.models import hourglass as port_hourglass
from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d
from h100_bench.harness import run_cell, spec, train, weights
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace
from h100_bench.reference import geometry as refgeo
from h100_bench.reference import hourglass, model
from h100_bench.tests.bench_tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CELL = "hg3_256.train_b16"
SEED = 2 ** 31 + 29
READER = "hg_fusion_share.train"


def hourglass_cell() -> spec.Cell:
    cell = tiny_cell(CELL, body="epipolarHG")
    cell.config["recipe"]["KEYPOINT"]["NFEATS"] = 32
    cell.config["recipe"]["SOLVER"]["IMS_PER_BATCH"] = 8
    return cell


def test_the_cell_names_the_hourglass_reference():
    cell = spec.load_cell(CELL)
    assert cell.reference is hourglass
    r = cell.recipe
    assert r["BACKBONE"]["BODY"] == hourglass.BODY == "epipolarHG"
    assert (hourglass.STACKS, hourglass.DEPTH) == (3, 3)
    assert (r["KEYPOINT"]["NFEATS"], r["KEYPOINT"]["LOSS"], r["KEYPOINT"]["NUM_PTS"]) == \
        (256, "mse", 17)
    assert cell.config["precision"] == "float32" and "DTYPE" not in r
    assert cell.chips == 1


def test_the_state_is_the_ports(tmp_path):
    cell = hourglass_cell()
    state = train.reference_state(cell, SEED, "cpu")
    _, port = train.build_program(cell.recipe, state, "cpu")  # raises on a name or shape
    keys = [k for k in port.reference.state_dict() if not k.endswith("num_batches_tracked")]
    assert keys == list(state)
    assert port.reference.final_layer is port.reference.tmpOut2


def test_the_weight_rules():
    recipe = spec.load_cell(CELL).recipe
    state = weights.make_state(hourglass.state_shapes(recipe), SEED, "cpu",
                               **hourglass.weight_rules)
    for name in ("stem_bn0", "tower0_bn", "tower2_bn", "epipolar_sampler.bn"):
        assert abs(float(state[f"{name}.weight"].mean()) - 0.25) < 0.02, name
    assert abs(float(state["hg1.mid.res0.bnB.weight"].mean()) - 1.0) < 0.05
    for name in ("tmpOut2", "trstmp0", "epipolar_sampler.z"):  # gain 1
        w = state[f"{name}.weight"]
        assert abs(float(w.std()) / (1 / w[0].numel()) ** 0.5 - 1) < 0.1, name
    w = state["hg0.res0.convB.weight"]  # He
    assert abs(float(w.std()) / (2 / w[0].numel()) ** 0.5 - 1) < 0.05
    assert state["tmpOut0.weight"].shape == (17, 256, 1, 1)
    assert "trsfea2.weight" not in state


def test_the_bound_is_three_calls_and_the_flops_count_both_views():
    cell = hourglass_cell()
    z = cell.sizes
    krt = torch.tensor([[[290.0, 0, 32, 0], [0, 290.0, 32, 0], [0, 0, 1, 3000.0]]])
    other = torch.tensor([[[290.0, 0, 32, 900.0], [0, 290.0, 32, 0], [0, 0, 1, 3000.0]]])
    locs = refgeo.sample_locations(krt, other, z.heatmap_hw, z.samples, z.stride)
    for backward in (False, True):
        one = model.attention_bound(locs, cell.recipe, "float32", backward)
        three = hourglass.attention_bound(locs, cell.recipe, "float32", backward)
        assert three["seconds"] == pytest.approx(3 * one["seconds"])
        assert three["flops"] == 3 * one["flops"] and three["bytes"] == 3 * one["bytes"]
    flops = hourglass.forward_flops(cell.recipe)
    h, w = z.heatmap_hw
    attention = 3 * 2 * 2 * h * w * z.samples * 32  # three calls of two einsums
    assert flops > attention
    # the reference view's fusion (attention and `z`) and last head are all
    # that the other view's pass lacks
    with torch.device("meta"):
        net = hourglass._model(cell.recipe)
    single = model.count_forward_flops(_SingleView(net), cell.recipe)
    z_conv, head = 3 * 2 * h * w * 32 * 32, 2 * h * w * 32 * 5
    assert flops - 2 * single == attention + z_conv + head


class _SingleView(torch.nn.Module):
    """One view's pass of `net` without the fusion (for the FLOPs)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, img, other_img, locs):
        return self.net.run(img)[0][-1]


def _trace(ops, start=0.0, end=10.0):
    ops = sorted(ops)
    return Trace(device=ops, spans=[], start=start, end=end, kernels=ops)


def _record(trace):
    return RunRecord(kind="train", setup_s=1.0, window_s=10.0, steps=2, items_per_step=2,
                     peak_window_bytes=0, forward_flops_per_item=1.0, peak_flops=1.0,
                     trace=trace, traced_steps=2, attention_bound_s={})


def test_the_reader_takes_the_brackets_of_each_phase(monkeypatch):
    reader = spec.reader(READER)
    m = reader.MARKS
    ops = [(0.5, 0.6, m["backward"][1]),  # the end of a step before the traced part
           (1.0, 1.1, "conv"), (1.1, 1.2, m["forward"][0]), (1.2, 1.5, "attention"),
           (1.5, 1.6, m["forward"][1]), (1.6, 1.7, m["forward"][0]), (1.7, 1.8, "z"),
           (1.8, 1.9, m["forward"][1]), (2.0, 2.1, m["backward"][0]),
           (2.1, 2.4, "attention_backward"), (2.5, 2.9, "bn_backward"),
           (2.9, 3.0, m["backward"][1]), (3.0, 3.5, "adam"), (3.6, 3.7, m["forward"][0]),
           (3.7, 3.9, "attention")]
    run = _record(_trace(ops))
    assert reader.fusion_brackets(run.trace) == {"forward": [(1.2, 1.5), (1.7, 1.8)],
                                                 "backward": [(2.1, 2.9)]}
    assert reader.read(run) == pytest.approx(100 * 1.1 / run.trace.busy_s())
    # the pooled attention's marks are not the hourglass's
    pooled = [(1.0, 1.1, "epipolar_pooled_forward_begin"), (1.2, 1.3, "gather"),
              (1.3, 1.4, "epipolar_pooled_forward_end")]
    for ops in (pooled, [(1.0, 1.1, "conv"), (1.2, 1.3, m["forward"][0])]):
        with pytest.raises(RuntimeError):
            reader.read(_record(_trace(ops)))
    # a program without the marks gives no reading
    monkeypatch.setattr(reader, "program_marks", lambda: False)
    assert reader.read(run) is None


def test_the_port_has_the_marks():
    assert spec.reader(READER).program_marks()


RUN = f'''
import json
import torch
import h100_bench
from h100_bench.harness import run_cell
from h100_bench.tests.test_h100_bench_hourglass import hourglass_cell
cell = hourglass_cell()
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
    assert got["reference"] == "h100_bench.reference.hourglass"
    assert got["correct"] is True, got["checks"]
    assert _digests(tmp_path) == before


def last_stack_loss(monkeypatch):
    real = port_builder.compute_stage_loss
    monkeypatch.setattr(port_builder, "compute_stage_loss",
                        lambda preds, target, mask=None: real(preds[-1:], target, mask))


def fusion_skipped(monkeypatch):  # the middle stack's merge point
    real = port_hourglass.HourglassNet._fuse

    def fuse(self, idx, feat, *args):
        if idx == 1:
            return feat, None, None, None
        return real(self, idx, feat, *args)

    monkeypatch.setattr(port_hourglass.HourglassNet, "_fuse", fuse)


def upsample_without_align_corners(monkeypatch):
    monkeypatch.setattr(port_hourglass, "resize_bilinear_align_corners",
                        lambda x, size: F.interpolate(x, size=tuple(size), mode="bilinear",
                                                      align_corners=False))


def bn_on_running_statistics(monkeypatch):
    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)

    monkeypatch.setattr(BatchNorm2d, "forward", forward)


@pytest.mark.parametrize("fault", [last_stack_loss, fusion_skipped,
                                   upsample_without_align_corners, bn_on_running_statistics])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(hourglass_cell(), SEED, 0.2, False, torch.device("cpu"), 0.0)
    assert result["correct"] is False, result["checks"]
