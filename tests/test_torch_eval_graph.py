"""The eval forward as one CUDA graph (engine/tester.py:make_eval_step).

The CPU tests of the capture policy that it shares with the train step
(engine/cuda_graph.py) are in tests/test_torch_cuda_graph.py.  On the CPU
here, on a toy model with the CUDA check forced and a recording stand-in
for the graph: a flip of `model.training`, another `train_bn` and a
replaced parameter never replay the old graph, while a weight changed in
place does; and soft-argmax's cached window offsets, bit-equal to the
`np.arange` they were made from and usable by autograd.

Marked `cuda` (on the card, python -m pytest --noconftest
tests/test_torch_eval_graph.py), with cuDNN deterministic: five distinct
view groups through the graphed step (the first eager, the second the
capture) against the eager forward of the same model, bit-equal in every
output, with the attention's launches counted alike (a replay adds the
captured forward's), for the tiny flagship and R-152 recipes and
TEST.TRAIN_BN; a train step between replays, which changes the weights and
BN's statistics in place, gives the eager outputs; successive replays
return tensors of their own.
"""

import numpy as np
import pytest
import torch
from torch import nn

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import cuda_graph, tester, trainer
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops import soft_argmax
from epipolar_transformers_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off and empty buffers."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


class Toy(nn.Module):
    """A linear map of the cameras with the eval forward's call and dict
    return; `bn_train` and train mode each shift the output."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(12, 2)

    def forward(self, inputs, bn_train=False):
        y = self.lin(inputs["KRT"].flatten(1)) + inputs["img"].float().mean()
        return {"y": y + 10.0 * bn_train + 100.0 * self.training}


class Recorded:
    """Stands in for cuda_graph.Graph on the CPU: records each capture's
    view count and runs the body eagerly at each replay."""

    made = []
    replayed = []

    def __init__(self, inputs, body):
        Recorded.made.append(inputs["KRT"].shape[0])
        self.body = body

    def __call__(self, inputs):
        Recorded.replayed.append(inputs["KRT"].shape[0])
        return self.body(inputs)


@pytest.fixture
def recorded(monkeypatch):
    """The stand-in in place of the graph, and every input taken for CUDA."""
    Recorded.made, Recorded.replayed = [], []
    monkeypatch.setattr(cuda_graph, "Graph", Recorded)
    monkeypatch.setattr(cuda_graph, "on_cuda", lambda inputs: True)
    return Recorded


def _group(views=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 255, (views, 8, 8, 3), dtype=np.uint8),
            "KRT": rng.standard_normal((views, 3, 4)).astype(np.float32)}


def _replays():
    """Replays counted under `eval_step` since tracing turned on."""
    spans, counters = tracing.drain()
    return sum(n for (i, name), n in counters.items()
               if name == tester.GRAPH_REPLAY_EVAL and i >= 0), {s.name for s in spans}


def test_a_flip_of_training_never_replays_the_old_graph(recorded):
    model = Toy()
    step = tester.make_eval_step(None, model, "cpu")
    group = _group()
    step(group)
    want = step(group)["y"]  # captured in eval mode
    model.train()
    tracing.enable()
    out = step(group)["y"]  # another key: eager, in train mode
    tracing.disable()
    assert _replays()[0] == 0 and torch.equal(out, want + 100.0)
    model.eval()
    assert torch.equal(step(group)["y"], want)  # the eval-mode graph again
    assert recorded.made == [4] and recorded.replayed == [4, 4]


def test_each_train_bn_replays_its_own_graph(recorded):
    model = Toy().eval()
    group = _group()
    eager = {bn: model(tester.to_model_inputs(group, "cpu"), bn_train=bn)["y"]
             for bn in (False, True)}
    for bn in (False, True):
        step = tester.make_eval_step(None, model, "cpu", train_bn=bn)
        outs = [step(group)["y"] for _ in range(3)]
        assert all(torch.equal(o, eager[bn]) for o in outs)
    assert recorded.made == [4, 4]


def test_a_replaced_parameter_captures_anew_and_an_in_place_change_replays(recorded):
    model = Toy()
    step = tester.make_eval_step(None, model, "cpu")
    group = _group()
    step(group)
    step(group)  # captured
    with torch.no_grad():
        model.lin.weight.mul_(2.0)  # the same memory: replayed
    tracing.enable()
    step(group)
    tracing.disable()
    assert _replays()[0] == 1
    model.lin.weight = nn.Parameter(model.lin.weight.detach().clone())
    tracing.enable()
    step(group)  # another address: eager
    tracing.disable()
    assert _replays()[0] == 0
    step(group)  # the new key repeated: captured anew
    assert len(recorded.made) == 2
    model.lin.bias = None  # a parameter gone: no key, eager
    tracing.enable()
    step(group)
    step(group)
    tracing.disable()
    assert _replays()[0] == 0 and len(recorded.made) == 2


@pytest.mark.parametrize("radius", [1, 2.5, 4.0, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_soft_argmax_offsets_are_the_arange_bit_for_bit(radius, dtype):
    iradius = int(radius + 0.5)
    want = torch.as_tensor(np.arange(-radius, radius + 1e-4, radius * 1.0 / iradius),
                           dtype=dtype)
    with torch.inference_mode():
        got = soft_argmax._offsets(float(radius), dtype, torch.device("cpu"))
    assert got.dtype == dtype and torch.equal(got, want)
    assert soft_argmax._offsets(float(radius), dtype, torch.device("cpu")) is got
    assert not got.is_inference()  # made once, usable by autograd too


def test_the_decode_with_cached_offsets_takes_gradients():
    heatmaps = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        first = soft_argmax.find_tensor_peak_batch(heatmaps, 2.5, 4)
    grad = heatmaps.clone().requires_grad_(True)
    locs, scores = soft_argmax.find_tensor_peak_batch(grad, 2.5, 4)
    (locs.sum() + scores.sum()).backward()
    assert torch.equal(locs.detach(), first[0]) and torch.isfinite(grad.grad).all()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


def _recipe(name):
    """The tiny flagship, its R-152 twin, or the flagship under TEST.TRAIN_BN."""
    cfg = flagship_cfg(tiny=True)
    if name == "r152":
        return update_from_dict(cfg, {"BACKBONE": {"BODY": "epipolarposeR-152"}})
    if name == "train_bn":
        return update_from_dict(cfg, {"TEST": {"TRAIN_BN": True}})
    return cfg


def _groups(cfg, n):
    ds = SyntheticMultiview(cfg, False, n)
    return [{k: v[0] for k, v in collate([ds[i]]).items()} for i in range(n)]


def _eager(model, group, device, train_bn):
    with torch.inference_mode():
        return model(tester.to_model_inputs(group, device), bn_train=train_bn)


def _assert_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert torch.equal(got[k], want[k]), (what, k)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["flagship", "r152", "train_bn"])
def test_replayed_groups_are_bit_equal_to_eager_ones(device, recipe):
    cfg = _recipe(recipe)
    groups = _groups(cfg, 5)
    model = trainer.build_model(cfg, device)
    train_bn = cfg.TEST.TRAIN_BN
    step = tester.make_eval_step(cfg, model, device, train_bn=train_bn)
    attn.LAUNCHES = 0
    outs = [step(g) for g in groups[:-1]]
    tracing.enable()
    outs.append(step(groups[-1]))
    tracing.disable()
    torch.cuda.synchronize()
    assert _replays()[0] == 1
    graphed_launches, attn.LAUNCHES = attn.LAUNCHES, 0
    for i, (g, out) in enumerate(zip(groups, outs)):
        _assert_equal(out, _eager(model, g, device, train_bn), i)
    layers = sum(m.route == "kernel" for m in model.modules() if isinstance(m, Epipolar))
    assert layers and graphed_launches == attn.LAUNCHES == len(groups) * layers
    assert not torch.equal(outs[1]["heatmap_pred"], outs[2]["heatmap_pred"])


@pytest.mark.cuda
def test_a_train_step_between_replays_gives_the_eager_outputs(device):
    cfg = flagship_cfg(tiny=True)
    groups = _groups(cfg, 3)
    model = trainer.build_model(cfg, device)
    step = tester.make_eval_step(cfg, model, device)
    step(groups[0])
    before = step(groups[1])  # captured and replayed
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=2, device_render=False)
    batch = tester.to_model_inputs(collate([ds[0], ds[1]]), device, tester.TRAIN_KEYS)
    trainer.make_train_step(cfg, model, make_optimizer(cfg, model))(batch)
    model.eval()
    tracing.enable()
    after = step(groups[1])
    tracing.disable()
    assert _replays()[0] == 1
    _assert_equal(after, _eager(model, groups[1], device, False), "after the train step")
    assert not torch.equal(after["heatmap_pred"], before["heatmap_pred"])


@pytest.mark.cuda
def test_successive_replays_return_tensors_of_their_own(device):
    cfg = flagship_cfg(tiny=True)
    groups = _groups(cfg, 4)
    model = trainer.build_model(cfg, device)
    step = tester.make_eval_step(cfg, model, device)
    outs, kept = [], []
    for g in groups:
        outs.append(step(g))
        kept.append({k: v.clone() for k, v in outs[-1].items()})
    for out, copy in zip(outs, kept):
        _assert_equal(out, copy, "overwritten by a later replay")
    ptrs = {out["heatmap_pred"].data_ptr() for out in outs}
    assert len(ptrs) == len(outs)
