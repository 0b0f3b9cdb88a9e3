"""The train step as one CUDA graph (engine/trainer.py:make_train_step).

The CPU tests of the capture policy that it shares with the eval forward
(engine/cuda_graph.py) are in tests/test_torch_cuda_graph.py.  On the CPU
here: `tracing.enable()` zeroing the attention's tile counts in place.

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

from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg, load_config, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
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
