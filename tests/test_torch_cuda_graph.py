"""The one capture policy of engine/cuda_graph.py, through both of its users:
the train step (engine/trainer.py:make_train_step) and the eval forward
(engine/tester.py:make_eval_step).

On the CPU, on a toy model with the CUDA check forced and a recording
stand-in for `cuda_graph.Graph` that runs the captured body at each replay.
Each rule that keeps a step eager, where a replay would skip what the step
must do (the CPU itself, a one-rank gloo group, a DistributedDataParallel
model in it, a module forward hook or pre-hook, a global forward hook,
training-mode dropout, tracing on at the capture; for the train step also
BATCH_MUL 2): no capture and no replay counted, where the same calls
without a rule capture once and replay.  The eval step puts the model in
eval mode, so a dropout module does not keep it eager.  The one graph a
step keeps: a lone other signature runs eagerly and keeps the graph, a
repeated one captures in its place; a new rate of the train schedule
captures anew.  The card's tests of each step are in
tests/test_torch_train_graph.py and tests/test_torch_eval_graph.py.
"""

import contextlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from epipolar_transformers_tpu_torch.engine import cuda_graph, tester, trainer
from epipolar_transformers_tpu_torch.engine.solver import Optimizer
from epipolar_transformers_tpu_torch.models.lifting import Dropout, _GeneratorSlot
from epipolar_transformers_tpu_torch.utils import tracing

STEPS = ("train", "eval")
COUNTER = {"train": trainer.GRAPH_REPLAY, "eval": tester.GRAPH_REPLAY_EVAL}
RULES = ["none", "cpu", "process_group", "ddp", "forward_hook", "forward_pre_hook",
         "global_forward_hook", "dropout", "tracing_on"]


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off and empty buffers."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


class Toy(nn.Module):
    """A linear map of the cameras, with the train forward's (loss_dict,
    metric_dict, out) return and the eval forward's `bn_train`."""

    def __init__(self, dropout: bool = False):
        super().__init__()
        self.lin = nn.Linear(12, 1)
        self.drop = Dropout(0.5 if dropout else 0.0, _GeneratorSlot(0))

    def forward(self, inputs, bn_train=False):
        y = self.lin(self.drop(inputs["KRT"].flatten(1))) + inputs["img"].float().mean()
        return {"loss": (y ** 2).mean()}, {"mean": y.mean().detach()}, {"y": y}


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


def _make(kind, net, capturable=True, batch_mul=1, schedule=lambda count: 1e-3):
    """`kind`'s step over `net`, called with a host view group, and the
    train step's optimizer (None for the eval step).  `capturable`: adam
    taken for capturable, as on CUDA parameters."""
    if kind == "eval":
        return tester.make_eval_step(None, net, "cpu"), None
    model = net.module if isinstance(net, DistributedDataParallel) else net
    optimizer = Optimizer(model.parameters(), "adam", schedule, batch_mul=batch_mul)
    optimizer.capturable = capturable
    step = trainer.make_train_step(None, net, optimizer)
    return lambda group: step(tester.to_model_inputs(group, "cpu")), optimizer


def _loss(kind, out):
    return out["loss"] if kind == "train" else out[0]["loss"]


@contextlib.contextmanager
def one_rank_group():
    """A gloo process group of one rank on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("step_kind, rule",
                         [(s, r) for s in STEPS for r in RULES] + [("train", "batch_mul2")])
def test_the_step_stays_eager_where_a_replay_would_skip_work(step_kind, rule, recorded,
                                                             monkeypatch):
    if rule == "cpu":
        monkeypatch.setattr(cuda_graph, "on_cuda",
                            lambda inputs: all(v.is_cuda for v in inputs.values()))
    torch.manual_seed(0)
    model = Toy(dropout=rule == "dropout").train()
    if rule == "forward_hook":
        model.register_forward_hook(lambda module, args, output: None)
    if rule == "forward_pre_hook":
        model.lin.register_forward_pre_hook(lambda module, args: None)
    handle = (nn.modules.module.register_module_forward_hook(lambda m, a, o: None)
              if rule == "global_forward_hook" else None)
    group = _group()
    try:
        with one_rank_group() if rule in ("process_group", "ddp") else contextlib.nullcontext():
            net = DistributedDataParallel(model) if rule == "ddp" else model
            step, _ = _make(step_kind, net, capturable=rule != "cpu",
                            batch_mul=2 if rule == "batch_mul2" else 1)
            if rule == "tracing_on":
                tracing.enable()
            first = step(group)
            step(group)  # the call that would capture
            tracing.enable()  # a replay may run with tracing on
            out = step(group)
            tracing.disable()
    finally:
        if handle is not None:
            handle.remove()
    spans, counters = tracing.drain()
    names = {s.name for s in spans}
    replays = sum(n for (i, name), n in counters.items()
                  if name == COUNTER[step_kind] and i >= 0)
    assert torch.isfinite(_loss(step_kind, out))
    if step_kind == "eval":
        assert torch.equal(out[2]["y"], first[2]["y"]) and "eval.forward" in names
    # the eval step runs the model in eval mode: its dropout draws nothing
    if rule == "none" or (rule, step_kind) == ("dropout", "eval"):
        assert recorded.made == [4] and recorded.replayed == [4, 4] and replays == 1
        if step_kind == "train":
            assert "train.replay" in names and "train.forward" not in names
    else:
        assert recorded.made == [] and replays == 0
        if step_kind == "train":
            assert "train.forward" in names and "train.replay" not in names


@pytest.mark.parametrize("step_kind", STEPS)
def test_a_call_with_another_signature_runs_eagerly(step_kind, recorded):
    """Only a key seen on the call before captures: a lone other view
    count (an epoch's smaller last batch) stays eager and keeps the graph."""
    step, optimizer = _make(step_kind, Toy())
    full, last = _group(4), _group(3)
    for group in (full, full, last, full):
        step(group)
    assert recorded.made == [4] and recorded.replayed == [4, 4]
    assert optimizer is None or optimizer.count == 4


@pytest.mark.parametrize("step_kind", STEPS)
def test_a_repeated_other_signature_captures_in_place_of_the_graph(step_kind, recorded):
    """The step keeps one graph: a second call in a row with another
    signature captures that signature's, and the first signature's calls
    then run eagerly until one repeats."""
    step, optimizer = _make(step_kind, Toy())
    four, three = _group(4), _group(3)
    for group in (four, four, three, three, four, three, four, four):
        step(group)
    assert recorded.made == [4, 3, 4] and recorded.replayed == [4, 3, 3, 4]
    assert optimizer is None or optimizer.count == 8


def test_a_new_rate_captures_anew(recorded):
    """The rate drops after two updates: the next call, whose signature is
    the graph's, captures anew at once, and the one after replays that
    graph at the new rate."""
    step, optimizer = _make("train", Toy(), schedule=lambda count: 1e-3 if count < 2 else 1e-4)
    group = _group()
    for _ in range(4):
        step(group)
    assert recorded.made == [4, 4] and recorded.replayed == [4, 4, 4]
    assert optimizer.count == 4 and optimizer.inner.param_groups[0]["lr"] == 1e-4


def test_clone_gives_tensors_of_their_own_in_the_same_structure():
    a, b = torch.zeros(2), torch.ones(3)
    out = cuda_graph.clone(({"a": a, "n": 1}, [b], None))
    assert isinstance(out, tuple) and isinstance(out[1], list) and out[0]["n"] == 1
    assert out[2] is None and torch.equal(out[0]["a"], a) and torch.equal(out[1][0], b)
    assert out[0]["a"].data_ptr() != a.data_ptr() and out[1][0].data_ptr() != b.data_ptr()
