"""The hourglass's tracing (models/hourglass.py, ops/trace_marks.py,
csrc/trace_marks.cu): the `hourglass.stem` and `hourglass.stack` spans and
the device marks `hourglass_fusion_{forward,backward}_{begin,end}` around
each merge point's whole fusion.

On the CPU, on `hg3_256.train_b16`'s recipe cut to 64 px, 16x16 heatmaps,
NFEATS 32, K=8, 5 joints, batch 2 (all three stacks): `MARKS` names the
`.cu` file's kernels in its order and count, and its switch launches each
by its index; a mark on the CPU loads no library and launches nothing; a
train step issues a forward bracket a stack in the forward and a backward
bracket a stack in the backward, begin and end in turn, and the other
view's pass issues none; the spans nest under `model.other_trunk` and
`model.reference`; the brackets change no value and no gradient.

Marked `cuda` (on the card, python -m pytest --noconftest
tests/test_torch_hourglass_marks.py): a replayed step of the tiny
hourglass runs three forward and three backward brackets, in a profiler's
device trace (in a process of its own), and the attention wrapper's host
counts advance by the captured step's three calls on each replay.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops import trace_marks
from epipolar_transformers_tpu_torch.utils import tracing
from h100_bench.harness import train, weights
from h100_bench.reference import hourglass
from test_torch_hourglass_h36m import batches, recipe

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 27
HG = tuple(m for m in trace_marks.MARKS if m.startswith("hourglass_fusion_"))
BRACKETS = {"forward": HG[:2], "backward": HG[2:]}


def program(device, n_batches=1):
    """(cfg, the port's model on the seed's weights, batches) on `device`."""
    r = recipe()
    state = weights.make_state(hourglass.state_shapes(r), SEED, device, **hourglass.weight_rules)
    cfg, model = train.build_program(r, state, device)
    return cfg, model.train(), batches(r, n_batches, device, SEED)


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


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


def test_marks_name_the_sources_kernels_in_order():
    source = (ROOT / "epipolar_transformers_tpu_torch/csrc/trace_marks.cu").read_text()
    kernels = re.findall(r'extern "C" __global__ void (\w+)\(\)', source)
    assert tuple(kernels) == trace_marks.MARKS
    cases = dict(re.findall(r"case (\d+): (\w+)<<<", source))
    assert {int(k): v for k, v in cases.items()} == dict(enumerate(trace_marks.MARKS))
    count = re.search(r"trace_mark_count\(\) \{ return (\d+); \}", source)
    assert int(count.group(1)) == len(trace_marks.MARKS) == 8
    assert HG == ("hourglass_fusion_forward_begin", "hourglass_fusion_forward_end",
                  "hourglass_fusion_backward_begin", "hourglass_fusion_backward_end")


def test_a_mark_on_the_cpu_launches_nothing(monkeypatch):
    def no_library():
        raise AssertionError("a CPU mark loaded the library")

    monkeypatch.setattr(trace_marks, "_library", no_library)
    for name in HG:
        trace_marks.mark(name, torch.device("cpu"))


def test_a_step_brackets_each_stacks_fusion(issued):
    _, model, data = program("cpu")
    tracing.enable()
    loss_dict, _, _ = model(data[0])
    forward = list(issued)
    loss_dict["loss"].backward()
    tracing.disable()
    spans, _ = tracing.drain()
    assert forward == list(BRACKETS["forward"]) * 3
    assert issued[len(forward):] == list(BRACKETS["backward"]) * 3
    names = [s.name for s in spans]
    for parent in ("model.other_trunk", "model.reference"):
        at = names.index(parent)
        children = [s.name for s in spans if s.parent == at]
        assert children == ["hourglass.stem"] + ["hourglass.stack"] * 3, parent
    stacks = [i for i, s in enumerate(spans) if s.name == "hourglass.stack"]
    fusions = [s for s in spans if s.name == "epipolar.fusion"]
    assert len(fusions) == 3 and all(s.parent in stacks[3:] for s in fusions)


def test_the_brackets_change_no_value_and_no_gradient(monkeypatch):
    runs = []
    for bracketed in (True, False):
        if not bracketed:
            monkeypatch.setattr(trace_marks, "enter", lambda mechanism, *t: t)
            monkeypatch.setattr(trace_marks, "leave", lambda mechanism, *t: t)
        _, model, data = program("cpu")
        loss_dict, _, out = model(data[0])
        loss_dict["loss"].backward()
        runs.append([out["heatmap_pred"].detach()] + [loss_dict[k].detach() for k in
                                                       sorted(loss_dict)] +
                    [p.grad for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    yield torch.device("cuda", 0)


# in a process of its own, as tests/test_torch_pooled_marks.py's card test
PROFILED = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {tests!r})
import test_torch_hourglass_marks as t
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops import trace_marks

device = torch.device("cuda", 0)
cfg, model, batches = t.program(device, 3)
step = trainer.make_train_step(cfg, model, make_optimizer(cfg, model, 1))
counts = [(attn.LAUNCHES, attn.BACKWARD_LAUNCHES)]
for b in batches[:2]:  # eager, then the capture and its first replay
    step(b)
    counts.append((attn.LAUNCHES, attn.BACKWARD_LAUNCHES))
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(3):
        step(batches[2])
    torch.cuda.synchronize()
counts.append((attn.LAUNCHES, attn.BACKWARD_LAUNCHES))
marks = [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                  key=lambda e: e.start_ns())
         if e.device_type().name == "CUDA" and e.name() in trace_marks.MARKS]
print(json.dumps({{"marks": marks, "counts": counts}}))
"""


@pytest.mark.cuda
def test_each_replayed_step_runs_three_brackets_of_each_phase(device):
    tests = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, "-c", PROFILED.format(tests=str(tests))],
                         cwd=tests.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    step = list(BRACKETS["forward"]) * 3 + list(BRACKETS["backward"]) * 3
    assert got["marks"] == step * 3
    # the eager step and each replay run the attention three times a step,
    # forward and backward
    deltas = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(got["counts"], got["counts"][1:])]
    assert deltas[:2] == [(3, 3), (3, 3)] and deltas[2] == (9, 9)
