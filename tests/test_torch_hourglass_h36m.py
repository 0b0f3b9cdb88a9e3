"""The port's three-stack epipolar hourglass of `hg3_256.train_b16`
(`h100_bench/configs/epipolar_hg3_256_f32.json`) against the benchmark's
plain reference of it (`h100_bench/reference/hourglass.py`), on the CPU.

The cell's recipe cut to 64 px, 16x16 heatmaps, NFEATS 32, K=8, 5 joints,
all three stacks at recursion 3 (16x16 down to 2x2), batch 2, on the
seed's weights (`harness/weights.py` with the reference's rules) and the
benchmark's own crops of its rig: the port through `ModelBuilder` (the
harness's `build_program`) and its optimizer, the reference through its
contract.  Compared: each stack's heatmaps of the reference view, each
stage loss and the total, every leaf's gradient, and the whole state
(parameters and BN's running statistics) after one adam step.

Both sides compute in float64 (the port's model `.double()` with every
convolution's compute dtype float64, the reference built in its "float64"
precision) on the same sample locations (the reference's, handed to the
port's layer in place of its own float32 geometry, which moves the lines by
up to ~2e-4 of the image), because under batch-statistics BN over 2x2 maps
of two items the hourglass's float32 gradients are ill-conditioned
(tests/test_torch_hourglass.py: f32 gradients stray by up to 3e-1 of a
leaf's max).  One float32 step is left on the port's side: its attention's
CPU twin, like the kernel, takes the bilinear corners and weights from the
locations in float32, which moves its output by ~1e-7 of its max.
Tolerances, from that (measured on this seed in brackets): heatmaps atol
1e-5 x their max (3.5e-7); the stage losses and the total rel 1e-6
(6.8e-8); each gradient atol 1e-4 x the larger of its leaf's max and the
median leaf's max (4.8e-6; the median floor because a convolution's bias
before a BN has a gradient that is zero but for rounding); the state after
one adam step atol 0.1 lr (0.018 lr: adam moves each element by about lr
whatever its gradient's size, so one whose gradient is near zero may move
the other way; a wrong update moves elements by up to 2 lr).
"""

import copy
import json
import statistics
from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.models import epipolar
from h100_bench.harness import compare, inputs, spec, train, weights
from h100_bench.reference import geometry as refgeo
from h100_bench.reference import hourglass
from h100_bench.reference.model import Adam

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 25


def recipe():
    """The cell's recipe at this file's cut."""
    config = json.loads((ROOT / "h100_bench/configs/epipolar_hg3_256_f32.json").read_text())
    r = copy.deepcopy(config["recipe"])
    r["DATASETS"]["IMAGE_SIZE"] = [64, 64]
    r["KEYPOINT"].update(HEATMAP_SIZE=[16, 16], NUM_PTS=5, SIGMA=2.0, NFEATS=32)
    r["EPIPOLAR"]["SAMPLESIZE"] = 8
    r["SOLVER"]["IMS_PER_BATCH"] = 2
    return r


def batches(r, n, device="cpu", seed=SEED):
    """`n` batches of 2 of the cell's traffic for the recipe `r`, the rig's
    frames cut to 250 px as its crops are."""
    traffic = json.loads((ROOT / "h100_bench/traffic/train_h36m_crops.json").read_text())
    traffic["rig"].update(frame_hw=[250, 250], focal_px=290.0)
    return inputs.train_batches(inputs.Rig(traffic, r, seed, device), 2, n)


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _steps():
    """One train step of each side in float64: the port's and the
    reference's readings, and the port."""
    cut = recipe()
    state = weights.make_state(hourglass.state_shapes(cut), SEED, "cpu",
                               **hourglass.weight_rules)
    batch = batches(cut, 1)[0]
    z = spec.sizes(cut)
    locs = refgeo.sample_locations(batch["KRT"], batch["other_KRT"], z.heatmap_hw, z.samples,
                                   z.stride)
    batch64 = {k: v.double() for k, v in batch.items()}

    cfg, port = train.build_program(cut, state, "cpu")
    port.double().train()
    for m in port.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    heads = {i: [] for i in range(3)}
    for i in range(3):
        getattr(port.reference, f"tmpOut{i}").register_forward_hook(
            lambda module, args, output, i=i: heads[i].append(output.detach()))
    optimizer = make_optimizer(cfg, port, 1000)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epipolar, "epipolar_sample_locs", lambda P1, P2, geom: locs.double())
        loss_dict, _, _ = port(batch64)
    optimizer.zero_grad(set_to_none=True)
    loss_dict["loss"].backward()
    n = len(compare.PREFIX)
    mine = {"heads": [heads[i][-1] for i in range(3)],
            "losses": {k: float(v.detach()) for k, v in loss_dict.items()},
            "grads": {name[n:]: p.grad.clone() for name, p in port.named_parameters()}}
    mine["before"] = {name[n:]: p.detach().clone() for name, p in port.named_parameters()}
    optimizer.step()
    mine["state"] = {k[n:]: v.clone() for k, v in port.state_dict().items()
                     if not k.endswith("num_batches_tracked")}

    ref = hourglass.build(cut, "float64", {k: v.double() for k, v in state.items()},
                          "cpu").train()
    params = dict(ref.named_parameters())
    heat = ref(batch64["img"], batch64["other_img"], locs)
    stage = [((h - batch64["heatmap"]) ** 2).mean() for h in heat.stages]
    total = hourglass.loss(heat, batch64)
    total.backward()
    theirs = {"heads": [h.detach() for h in heat.stages],
              "losses": {**{f"stage_loss{i}": float(s.detach()) for i, s in enumerate(stage)},
                         "loss": float(total.detach())},
              "grads": {name: p.grad.clone() for name, p in params.items()}}
    Adam(list(params.values()), float(cut["SOLVER"]["BASE_LR"])).step()
    theirs["state"] = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    return mine, theirs, port


@pytest.fixture(scope="module")
def step(one_thread):
    return _steps()


def test_each_stacks_heatmaps_match_the_reference(step):
    mine, theirs, _ = step
    assert len(mine["heads"]) == len(theirs["heads"]) == 3
    for got, want in zip(mine["heads"], theirs["heads"]):
        assert got.dtype == want.dtype == torch.float64
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_each_stage_loss_matches_the_reference(step):
    mine, theirs, _ = step
    assert set(mine["losses"]) == {"stage_loss0", "stage_loss1", "stage_loss2", "loss"}
    for k, want in theirs["losses"].items():
        assert mine["losses"][k] == pytest.approx(want, rel=1e-6), k


def test_every_gradient_matches_the_reference(step):
    mine, theirs, _ = step
    assert set(mine["grads"]) == set(theirs["grads"])
    scale = {name: float(g.abs().max()) for name, g in theirs["grads"].items()}
    median = statistics.median(scale.values())
    for name, want in theirs["grads"].items():
        torch.testing.assert_close(mine["grads"][name], want, rtol=0,
                                   atol=1e-4 * max(scale[name], median), msg=name)
    # every stack is supervised: the earlier stacks' heads get a gradient
    assert all(float(theirs["grads"][f"tmpOut{i}.weight"].abs().max()) > 0 for i in range(3))


def test_one_adam_step_matches_the_reference(step):
    mine, theirs, _ = step
    assert list(mine["state"]) == list(theirs["state"])
    lr = float(recipe()["SOLVER"]["BASE_LR"])
    for name, want in theirs["state"].items():
        torch.testing.assert_close(mine["state"][name], want, rtol=0, atol=0.1 * lr, msg=name)
    # the step moved every parameter
    assert all(not torch.equal(theirs["state"][n], mine["before"][n]) for n in mine["grads"])


def test_final_layer_is_the_last_stacks_head_and_adds_no_key(step):
    *_, port = step
    net = port.reference
    assert net.final_layer is net.tmpOut2
    assert "final_layer" not in dict(net.named_children())
    keys = [k for k in net.state_dict() if not k.endswith("num_batches_tracked")]
    assert not any("final_layer" in k for k in net.state_dict())
    # the reference's names, in the port's state_dict order
    assert keys == list(hourglass.state_shapes(recipe()))
