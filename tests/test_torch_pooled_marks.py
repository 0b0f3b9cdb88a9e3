"""The POOLING route's tracing (models/epipolar.py, ops/trace_marks.py,
ops/epipolar_attention_pooled.py): the `epipolar.pooled_attention` span
under `epipolar.fusion`, the device marks around the attention's forward
and backward, and the `attn.pooled_samples` counter, on the tiny flagship
recut to the param recipe's fusion (theta/phi/g at NFEATS / 2, K samples
pooled in pairs, z + BN without residual, the uncorrected normalization).

On the CPU, on the pooled kernels' route (their plain twin there) and on
the plain streaming route: the marks are issued once each a call, in the
order forward begin, forward end, backward begin, backward end, around the
attention alone; the brackets change no value and no gradient; the counter
counts the keys' and the values' samples once a call; the kernel route
(the tiny flagship) has none of them.

Marked `cuda` (on the card, python -m pytest --noconftest
tests/test_torch_pooled_marks.py), with cuDNN deterministic: the tiny param
model's graphed train steps, through the pooled kernels, bit-equal to eager
steps; each replayed step runs each mark once, in order, in a profiler's
device trace (in a process of its own); and replays advance the counter as
eager steps do.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import trace_marks
from epipolar_transformers_tpu_torch.ops.epipolar_attention_pooled import POOLED_SAMPLES
from epipolar_transformers_tpu_torch.utils import tracing

PARAM = {"EPIPOLAR": {"PARAMETERIZED": ("z", "theta", "phi", "g"), "POOLING": True,
                      "BOTTLENECK": 2, "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": False}}
COUNTER = "attn.pooled_samples"
# the pooled attention's marks, in MARKS's order (the hourglass's follow them)
POOLED = tuple(m for m in trace_marks.MARKS if m.startswith("epipolar_pooled_"))


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off, empty buffers and no
    pooled counts."""
    tracing.disable()
    tracing.drain()
    POOLED_SAMPLES.clear()
    yield
    tracing.disable()
    tracing.drain()
    POOLED_SAMPLES.clear()


def _cfg(param=True):
    cfg = flagship_cfg(tiny=True)
    return update_from_dict(cfg, PARAM) if param else cfg


def _batches(cfg, device, n, items=2):
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=n * items, device_render=False)
    return [to_model_inputs(collate([ds[j] for j in range(i * items, (i + 1) * items)]),
                            device, TRAIN_KEYS) for i in range(n)]


def _fusion_inputs(cfg, generator):
    h, w = cfg.KEYPOINT.HEATMAP_SIZE
    feat = torch.randn(2, 256, h, w, generator=generator, requires_grad=True)
    other = torch.randn(2, 256, h, w, generator=generator, requires_grad=True)
    P = torch.tensor([[[300.0, 0, 16, 0], [0, 300.0, 16, 0], [0, 0, 1, 3000.0]]])
    P2 = torch.tensor([[[300.0, 0, 16, 900.0], [0, 300.0, 16, 0], [0, 0, 1, 3000.0]]])
    return feat, other, P.expand(2, 3, 4), P2.expand(2, 3, 4)


def _layer(cfg):
    layer = Epipolar(cfg)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return layer.train()


@pytest.fixture
def issued(monkeypatch):
    """The marks issued by the host, in order."""
    seen = []
    real = trace_marks.mark

    def mark(name, device):
        seen.append(name)
        real(name, device)

    monkeypatch.setattr(trace_marks, "mark", mark)
    return seen


# the pooled kernels' route (ops/epipolar_attention_pooled_cuda.py; on the
# CPU its plain twin) and the plain streaming route (cos similarity)
ROUTES = [({}, True), ({"SIMILARITY": "cos"}, False)]


@pytest.mark.parametrize("epipolar,kernel", ROUTES, ids=["kernel", "plain"])
def test_marks_bracket_the_pooled_attention_once_a_call(issued, epipolar, kernel):
    cfg = update_from_dict(_cfg(), {"EPIPOLAR": epipolar})
    layer = _layer(cfg)
    assert layer.route == "streaming" and layer.pooled_kernel == kernel
    feat, other, P1, P2 = _fusion_inputs(cfg, torch.Generator().manual_seed(0))
    tracing.enable()
    fused, *_ = layer(feat, other, P1, P2)
    fused.square().sum().backward()
    tracing.disable()
    spans, counters = tracing.drain()
    assert issued == list(POOLED)
    names = [s.name for s in spans]
    assert names == ["epipolar.fusion", "epipolar.pooled_attention"]
    assert spans[1].parent == 0
    N, K, (h, w) = 2, cfg.EPIPOLAR.SAMPLESIZE, cfg.KEYPOINT.HEATMAP_SIZE
    assert counters == {(-1, COUNTER): N * K * h * w * 2}  # keys and values


@pytest.mark.parametrize("epipolar,kernel", ROUTES, ids=["kernel", "plain"])
def test_the_brackets_change_no_value_and_no_gradient(monkeypatch, epipolar, kernel):
    cfg = update_from_dict(_cfg(), {"EPIPOLAR": epipolar})
    layer = _layer(cfg)
    assert layer.pooled_kernel == kernel
    runs = []
    for bracketed in (True, False):
        if not bracketed:  # the layer's plain call, without marks, span or count
            monkeypatch.setattr(layer, "_pooled", layer._plain)
        feat, other, P1, P2 = _fusion_inputs(cfg, torch.Generator().manual_seed(0))
        layer.zero_grad()
        fused, *_ = layer(feat, other, P1, P2)
        fused.square().sum().backward()
        runs.append([fused.detach(), feat.grad, other.grad] +
                    [p.grad.clone() for p in layer.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_keys_equal_to_values_count_once():
    cfg = update_from_dict(_cfg(), {"EPIPOLAR": {"PARAMETERIZED": ("z",), "BOTTLENECK": 1}})
    layer = _layer(cfg)
    assert layer.shared_kv and layer.route == "streaming"
    feat, other, P1, P2 = _fusion_inputs(cfg, torch.Generator().manual_seed(0))
    tracing.enable()
    layer(feat, other, P1, P2)
    tracing.disable()
    N, K, (h, w) = 2, cfg.EPIPOLAR.SAMPLESIZE, cfg.KEYPOINT.HEATMAP_SIZE
    assert tracing.drain()[1] == {(-1, COUNTER): N * K * h * w}


def test_the_kernel_route_has_no_marks_span_or_count(issued):
    cfg = _cfg(param=False)
    layer = _layer(cfg)
    assert layer.route == "kernel"
    feat, other, P1, P2 = _fusion_inputs(cfg, torch.Generator().manual_seed(0))
    tracing.enable()
    fused, *_ = layer(feat, other, P1, P2)
    fused.square().sum().backward()
    tracing.disable()
    spans, counters = tracing.drain()
    assert issued == []
    assert [s.name for s in spans] == ["epipolar.fusion"]
    assert counters == {} and POOLED_SAMPLES == {}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


def _steps(cfg, device, batches, eager):
    """A fresh seeded model through make_train_step on `batches`, kept
    eager by a forward hook that does nothing where `eager`; the model,
    its optimizer, the outputs and the replays counted."""
    model = trainer.build_model(cfg, device)
    if eager:
        model.register_forward_hook(lambda module, args, output: None)
    optimizer = make_optimizer(cfg, model, 1)
    step = trainer.make_train_step(cfg, model, optimizer)
    outs = [step(b) for b in batches[:-1]]
    tracing.enable()
    outs.append(step(batches[-1]))
    tracing.disable()
    torch.cuda.synchronize()
    counters = tracing.drain()[1]
    replays = sum(n for (_, name), n in counters.items() if name == trainer.GRAPH_REPLAY)
    return model, optimizer, outs, replays, counters.get((-1, COUNTER))


@pytest.mark.cuda
def test_graphed_param_steps_are_bit_equal_to_eager_steps(device):
    cfg = _cfg()
    batches = _batches(cfg, device, 4)
    graphed = _steps(cfg, device, batches, eager=False)
    eager = _steps(cfg, device, batches, eager=True)
    assert graphed[3] == 1 and eager[3] == 0
    for x, y in zip(graphed[2], eager[2]):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (k, v), v2 in zip(graphed[0].state_dict().items(), eager[0].state_dict().values()):
        assert torch.equal(v, v2), k
    for p, p2 in zip(graphed[1].params, eager[1].params):
        s, s2 = graphed[1].inner.state[p], eager[1].inner.state[p2]
        assert torch.equal(s["exp_avg"], s2["exp_avg"]) and \
            torch.equal(s["exp_avg_sq"], s2["exp_avg_sq"])
    # the traced last step, a replay in one and eager in the other, counts alike
    N, K, (h, w) = 2, cfg.EPIPOLAR.SAMPLESIZE, cfg.KEYPOINT.HEATMAP_SIZE
    assert graphed[4] == eager[4] == N * K * h * w * 2


# in a process of its own: a profiler over graph replays left this
# process's later profilers blind to cuDNN's kernels
# (tests/test_torch_bn_stats.py's card test, run after it, saw none)
PROFILED = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {tests!r})
import test_torch_pooled_marks as t
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.ops import trace_marks

torch.backends.cudnn.deterministic = True
device = torch.device("cuda", 0)
cfg = t._cfg()
batches = t._batches(cfg, device, 3)
model = trainer.build_model(cfg, device)
step = trainer.make_train_step(cfg, model, make_optimizer(cfg, model, 1))
for b in batches[:2]:  # eager, then the capture and its first replay
    step(b)
torch.cuda.synchronize()
issued = []
real = trace_marks.mark
trace_marks.mark = lambda name, dev: (issued.append(name), real(name, dev))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        step(batches[2])
    torch.cuda.synchronize()
marks = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                  key=lambda e: e.start_ns())
         if e.device_type().name == "CUDA" and e.name() in trace_marks.MARKS]
print(json.dumps({{"marks": marks, "issued": issued}}))
"""


@pytest.mark.cuda
def test_each_replayed_step_runs_each_mark_once_in_order(device):
    tests = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-c", PROFILED.format(tests=str(tests))],
                         cwd=tests.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["issued"] == []  # replays run no Python of the marks
    assert got["marks"] == list(POOLED) * 3
