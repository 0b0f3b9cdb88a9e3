"""The train step as one CUDA graph (engine/trainer.py:make_train_step).

On the CPU: the rule that keeps a step eager, where a replay would skip
what the step must do (the CPU itself, a DistributedDataParallel model in a
one-rank gloo group, BATCH_MUL 2, a forward hook, dropout drawing from the
lifting nets' generator, tracing on), on a toy model with the CUDA check
forced and a recording stand-in for the graph: no capture and no
`train.graph_replay`, where the same steps without a rule capture once and
replay; the one graph a step keeps (a lone other signature runs eagerly, a
repeated one captures in its place); and `tracing.enable()` zeroing the
attention's tile counts in place.

Marked `cuda` (on the card, python -m pytest --noconftest
tests/test_torch_train_graph.py), with cuDNN deterministic: graphed steps
against the same steps kept eager by a no-op forward hook, from the same
seeded weights, bit-equal in the losses, every parameter and buffer, and
adam's moments, since every kernel sums in a fixed order
(tests/test_torch_cuda.py), and with the attention's launches counted
alike (a replay adds the captured step's): four steps of the tiny flagship and R-152
recipes; a schedule milestone crossed between replays (a new capture); a
new input shape between replays (run eagerly).  The epipolarHG1 recipe,
whose eager steps are not bit-reproducible, captures and matches eager's
losses to 5e-2.  Two successive replays return loss tensors of their own.
"""

import contextlib
import socket
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from epipolar_transformers_tpu_torch.config import flagship_cfg, load_config, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.solver import Optimizer, make_optimizer
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.models.lifting import Dropout, _GeneratorSlot
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
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
    """A linear fit with the model's (loss_dict, metric_dict, out) return."""

    def __init__(self, dropout: bool = False):
        super().__init__()
        self.lin = nn.Linear(4, 1)
        self.drop = Dropout(0.5 if dropout else 0.0, _GeneratorSlot(0))

    def forward(self, inputs):
        y = self.lin(self.drop(inputs["x"]))
        return {"loss": ((y - inputs["y"]) ** 2).mean()}, {"mean": y.mean().detach()}, {}


class Recorded:
    """Stands in for trainer._Graph on the CPU: records each capture and
    steps eagerly."""

    made = []

    def __init__(self, model, optimizer, inputs):
        Recorded.made.append(model)
        self.model, self.lr = model, optimizer.set_lr()

    def __call__(self, inputs, optimizer):
        loss_dict, metric_dict, _ = self.model(inputs)
        optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in {**loss_dict, **metric_dict}.items()}


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


RULES = ["none", "cpu", "ddp", "batch_mul2", "forward_hook", "dropout", "tracing_on"]


@pytest.mark.parametrize("rule", RULES)
def test_the_step_stays_eager_where_a_replay_would_skip_work(rule, monkeypatch):
    Recorded.made = []
    monkeypatch.setattr(trainer, "_Graph", Recorded)
    if rule != "cpu":  # as if every parameter and input were on CUDA
        monkeypatch.setattr(trainer, "_on_cuda", lambda optimizer, inputs: True)
    torch.manual_seed(0)
    model = Toy(dropout=rule == "dropout").train()
    if rule == "forward_hook":
        model.register_forward_hook(lambda module, args, output: None)
    optimizer = Optimizer(model.parameters(), "adam", lambda count: 1e-3,
                          batch_mul=2 if rule == "batch_mul2" else 1)
    inputs = {"x": torch.randn(8, 4), "y": torch.randn(8, 1)}
    with one_rank_group() if rule == "ddp" else contextlib.nullcontext():
        net = DistributedDataParallel(model) if rule == "ddp" else model
        step = trainer.make_train_step(None, net, optimizer)
        if rule == "tracing_on":
            tracing.enable()
        step(inputs)
        step(inputs)  # the call that would capture
        tracing.enable()  # a replay may run with tracing on
        out = step(inputs)
        tracing.disable()
    spans, counters = tracing.drain()
    names = {s.name for s in spans}
    replays = sum(n for (_, name), n in counters.items() if name == trainer.GRAPH_REPLAY)
    assert torch.isfinite(out["loss"])
    if rule == "none":
        assert len(Recorded.made) == 1 and replays == 1
        assert "train.replay" in names and "train.forward" not in names
    else:
        assert Recorded.made == [] and replays == 0
        assert "train.forward" in names and "train.replay" not in names


def test_a_call_with_another_signature_runs_eagerly(monkeypatch):
    """Only a signature seen on the call before captures: a lone other
    shape (an epoch's smaller last batch) stays eager and keeps the graph."""
    Recorded.made = []
    monkeypatch.setattr(trainer, "_Graph", Recorded)
    monkeypatch.setattr(trainer, "_on_cuda", lambda optimizer, inputs: True)
    model = Toy().train()
    optimizer = Optimizer(model.parameters(), "adam", lambda count: 1e-3)
    step = trainer.make_train_step(None, model, optimizer)
    full = {"x": torch.randn(8, 4), "y": torch.randn(8, 1)}
    last = {"x": torch.randn(3, 4), "y": torch.randn(3, 1)}
    for inputs in (full, full, last, full):
        step(inputs)
    assert len(Recorded.made) == 1 and optimizer.count == 4


def test_a_repeated_other_signature_captures_in_place_of_the_graph(monkeypatch):
    """The step keeps one graph: a second call in a row with another
    signature captures that signature's, and the first signature's calls
    then run eagerly until one repeats."""
    made, replayed = [], []

    class Counted(Recorded):
        def __init__(self, model, optimizer, inputs):
            made.append(inputs["x"].shape[0])
            super().__init__(model, optimizer, inputs)

        def __call__(self, inputs, optimizer):
            replayed.append(inputs["x"].shape[0])
            return super().__call__(inputs, optimizer)

    monkeypatch.setattr(trainer, "_Graph", Counted)
    monkeypatch.setattr(trainer, "_on_cuda", lambda optimizer, inputs: True)
    model = Toy().train()
    optimizer = Optimizer(model.parameters(), "adam", lambda count: 1e-3)
    step = trainer.make_train_step(None, model, optimizer)
    full = {"x": torch.randn(8, 4), "y": torch.randn(8, 1)}
    small = {"x": torch.randn(3, 4), "y": torch.randn(3, 1)}
    for inputs in (full, full, small, small, full, small, full, full):
        step(inputs)
    assert made == [8, 3, 8] and replayed == [8, 3, 3, 8] and optimizer.count == 8


def test_enable_zeroes_the_tile_counts_in_place():
    """A graph keeps adding into the tile-count tensor it captured, so
    turning tracing on zeroes that tensor rather than dropping it."""
    key = torch.device("cpu")
    pair = attn.TILE_COUNTS[key] = torch.tensor([5, 7], dtype=torch.int64)
    try:
        tracing.enable()
        assert attn.TILE_COUNTS[key] is pair and pair.tolist() == [0, 0]
        pair += torch.tensor([3, 1])  # what a replay's kernels add
        tracing.disable()
        _, counters = tracing.drain()
        assert counters[(-1, "attn.forward_tiles.tile_path")] == 3
        assert counters[(-1, "attn.forward_tiles.per_query_path")] == 1
        tracing.enable()  # nothing counted since: no counters
        tracing.disable()
        assert tracing.drain() == ([], {})
    finally:
        attn.TILE_COUNTS.pop(key)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


def _recipe(name):
    """The tiny flagship, or its R-152 twin."""
    if name == "flagship":
        return flagship_cfg(tiny=True)
    return update_from_dict(flagship_cfg(tiny=True), {"BACKBONE": {"BODY": "epipolarposeR-152"}})


def _batches(cfg, device, sizes):
    """One train batch of each of `sizes` items, on `device`."""
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=sum(sizes), device_render=False)
    out, start = [], 0
    for n in sizes:
        out.append(to_model_inputs(collate([ds[i] for i in range(start, start + n)]), device,
                                   TRAIN_KEYS))
        start += n
    return out


def _steps(cfg, device, batches, eager, steps_per_epoch=1):
    """A fresh seeded model through make_train_step on `batches`, kept
    eager by a forward hook that does nothing where `eager`; returns the
    model, its optimizer, the outputs, the replays counted on the last
    call (traced) and the attention's forward and backward launches, as
    its wrapper counts them on the host."""
    model = trainer.build_model(cfg, device)
    if eager:
        model.register_forward_hook(lambda module, args, output: None)
    optimizer = make_optimizer(cfg, model, steps_per_epoch)
    step = trainer.make_train_step(cfg, model, optimizer)
    attn.LAUNCHES = attn.BACKWARD_LAUNCHES = 0
    outs = [step(b) for b in batches[:-1]]
    tracing.enable()
    outs.append(step(batches[-1]))
    tracing.disable()
    torch.cuda.synchronize()
    counters = tracing.drain()[1]
    replays = sum(n for (_, name), n in counters.items() if name == trainer.GRAPH_REPLAY)
    return model, optimizer, outs, replays, (attn.LAUNCHES, attn.BACKWARD_LAUNCHES)


def _assert_bit_equal(a, b):
    (model, optimizer, outs, *_), (model2, optimizer2, outs2, *_) = a, b
    for i, (x, y) in enumerate(zip(outs, outs2)):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), (i, k)
    for (k, v), v2 in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(v, v2), k
    assert optimizer.count == optimizer2.count
    for p, p2 in zip(optimizer.params, optimizer2.params):
        s, s2 = optimizer.inner.state[p], optimizer2.inner.state[p2]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s[k], s2[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["flagship", "r152"])
def test_graphed_steps_are_bit_equal_to_eager_steps(device, recipe):
    cfg = _recipe(recipe)
    batches = _batches(cfg, device, [2] * 4)
    graphed = _steps(cfg, device, batches, eager=False)
    eager = _steps(cfg, device, batches, eager=True)
    assert graphed[3] == 1 and eager[3] == 0
    _assert_bit_equal(graphed, eager)
    # a replay counts the kernels it runs: one of each a kernel-route layer and step
    layers = sum(m.route == "kernel" for m in graphed[0].modules() if isinstance(m, Epipolar))
    assert layers and graphed[4] == eager[4] == (len(batches) * layers,) * 2


@pytest.mark.cuda
def test_graphed_hourglass_steps_match_eager_steps(device):
    """epipolarHG1's eager steps are not bit-reproducible on the card: two
    eager runs of these four steps differ by up to 2.5% in the loss, and
    torch's deterministic mode names no op.  The graph's losses are held to
    eager's at rtol 5e-2; the first step, eager in both, is bit-equal."""
    cfg = load_config(str(Path(__file__).parents[1] / "configs/epipolar/synthetic_hg.yaml"))
    batches = _batches(cfg, device, [2] * 4)
    graphed = _steps(cfg, device, batches, eager=False)
    eager = _steps(cfg, device, batches, eager=True)
    assert graphed[3] == 1
    got, want = (torch.stack([out["loss"] for out in run[2]]) for run in (graphed, eager))
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got, want, rtol=5e-2, atol=0)


@pytest.mark.cuda
def test_a_milestone_between_replays_gives_the_eager_parameters(device):
    """The rate drops after two updates (epoch 1 of 2 steps): the third
    call captures anew at the new rate."""
    cfg = update_from_dict(flagship_cfg(tiny=True), {"SOLVER": {"STEPS": (1,), "GAMMA": 0.1}})
    batches = _batches(cfg, device, [2] * 5)
    graphed = _steps(cfg, device, batches, eager=False, steps_per_epoch=2)
    eager = _steps(cfg, device, batches, eager=True, steps_per_epoch=2)
    assert graphed[1].inner.param_groups[0]["lr"] == pytest.approx(1e-4)
    assert graphed[3] == 1
    _assert_bit_equal(graphed, eager)


@pytest.mark.cuda
def test_a_new_input_shape_between_replays_runs_eagerly(device):
    cfg = flagship_cfg(tiny=True)
    batches = _batches(cfg, device, [2, 2, 2, 3, 2])
    graphed = _steps(cfg, device, batches, eager=False)
    eager = _steps(cfg, device, batches, eager=True)
    assert graphed[3] == 1  # the last call replays the graph of two items
    _assert_bit_equal(graphed, eager)


@pytest.mark.cuda
def test_successive_replays_return_tensors_of_their_own(device):
    cfg = flagship_cfg(tiny=True)
    batches = _batches(cfg, device, [2] * 4)
    model = trainer.build_model(cfg, device)
    step = trainer.make_train_step(cfg, model, make_optimizer(cfg, model))
    outs, losses = [], []
    for b in batches:
        outs.append(step(b))
        losses.append(outs[-1]["loss"].item())
    assert [out["loss"].item() for out in outs] == losses  # none overwritten
    assert len(set(losses)) == 4
