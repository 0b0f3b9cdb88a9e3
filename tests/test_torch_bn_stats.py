"""Training BatchNorm's running statistics from the normalization's own
moments (models/layers.py:BatchNorm2d, one process).

On the CPU, in float32 and float64, on contiguous and channels_last
inputs: the training forward and its gradients with respect to the input,
weight and bias bit-equal to `F.batch_norm`; the running mean and variance
after one and three forwards equal to a `var_mean` reference moved by
flax's rule (biased variance, `running + momentum (batch - running)`), at
the default momentum and at a configured BACKBONE.BN_MOMENTUM; a constant
channel's running variance never below 0; and, under an op counter, no
reduction over the input besides the normalization itself, with at most
three ops for the update (the `var_mean` pass and two `lerp_`s it
replaced).

Marked `cuda` (on the card, python -m pytest --noconftest
tests/test_torch_bn_stats.py): on flagship-sized channels_last float32
activations, the same equalities against cuDNN's `F.batch_norm`, and under
`torch.profiler` the forward runs cuDNN's batch norm and no
`reduce_kernel`, which a `var_mean` over the same input does run.
"""

import pytest
import torch
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.models.layers import BatchNorm2d, bn_momentum

DTYPES = [torch.float32, torch.float64]
LAYOUTS = ["contiguous", "channels_last"]
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
REDUCTIONS = {"var_mean", "var", "mean", "sum"}


def _momentum(which):
    """The default BACKBONE.BN_MOMENTUM, or one a config sets."""
    cfg = flagship_cfg(tiny=True)
    if which == "configured":
        cfg = update_from_dict(cfg, {"BACKBONE": {"BN_MOMENTUM": 0.3}})
    return bn_momentum(cfg)


def _input(shape, dtype, layout, device="cpu", seed=0):
    """Activations with per-channel offsets and scales, so that every
    channel's mean and variance are well away from 0."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    offset = torch.linspace(0.5, 2.5, c, dtype=torch.float64).view(1, c, 1, 1)
    scale = torch.linspace(0.2, 3.0, c, dtype=torch.float64).view(1, c, 1, 1)
    x = (torch.randn(shape, generator=g, dtype=torch.float64) * scale + offset).to(dtype)
    x = x.to(device)
    return x.to(memory_format=torch.channels_last) if layout == "channels_last" else x


def _bn(c, dtype, momentum=0.1, device="cpu", seed=1):
    bn = BatchNorm2d(c, eps=1e-5, momentum=momentum).to(device=device, dtype=dtype).train()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g, dtype=torch.float64) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g, dtype=torch.float64))
    return bn


def _reference_running(bn, xs):
    """`var_mean` over each input, moved by flax's rule."""
    mean = torch.zeros_like(bn.running_mean)
    var = torch.ones_like(bn.running_var)
    for x in xs:
        v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        mean = mean + bn.momentum * (m - mean)
        var = var + bn.momentum * (v - var)
    return mean, var


def _forward_and_grads(fn, x, bn, grad):
    x = x.detach().requires_grad_(True)
    bn.zero_grad(set_to_none=True)
    out = fn(x)
    out.backward(grad)
    return out.detach(), x.grad, bn.weight.grad, bn.bias.grad


def _assert_equals_f_batch_norm(bn, x):
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(2),
                       dtype=torch.float64).to(x).to(memory_format=torch.contiguous_format)
    got = _forward_and_grads(bn, x, bn, grad)
    want = _forward_and_grads(
        lambda t: F.batch_norm(t, None, None, bn.weight, bn.bias, True, 0.0, bn.eps), x, bn, grad)
    for name, a, b in zip(("output", "d input", "d weight", "d bias"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_training_forward_and_its_gradients_equal_f_batch_norm(dtype, layout):
    _assert_equals_f_batch_norm(_bn(6, dtype), _input((4, 6, 5, 7), dtype, layout))


@pytest.mark.parametrize("momentum", ["default", "configured"])
@pytest.mark.parametrize("forwards", [1, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_running_statistics_follow_var_mean_and_flax_rule(dtype, layout, forwards, momentum):
    bn = _bn(6, dtype, _momentum(momentum))
    xs = [_input((4, 6, 5, 7), dtype, layout, seed=s) for s in range(forwards)]
    for x in xs:
        bn(x)
    mean, var = _reference_running(bn, xs)
    torch.testing.assert_close(bn.running_mean, mean, rtol=RTOL[dtype], atol=0)
    torch.testing.assert_close(bn.running_var, var, rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_constant_channel_keeps_a_running_variance_of_at_least_0(dtype, layout):
    """At momentum 1 the running variance is the batch's own: 0 or a
    rounding above it, never below."""
    x = _input((4, 6, 5, 7), dtype, layout)
    for c, value in enumerate((0.0, 7.25, -3.1, 1e3)):
        x[:, c] = value
    bn = _bn(6, dtype, momentum=1.0)
    for _ in range(3):
        bn(x)
    assert (bn.running_var[:4] >= 0).all(), bn.running_var[:4].tolist()
    assert (bn.running_var[:4] < 1e-9).all(), bn.running_var[:4].tolist()


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_training_forward_runs_no_second_statistics_pass(dtype, layout):
    bn = _bn(6, dtype)
    x = _input((4, 6, 5, 7), dtype, layout)
    with _OpCounter() as counter:
        bn(x)
    norms = [op for op in counter.ops if "batch_norm" in op]
    assert len(norms) == 1, counter.ops
    assert not REDUCTIONS & set(counter.ops), counter.ops
    update = counter.ops[counter.ops.index(norms[0]) + 1:]
    assert len(update) <= 3, update


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = saved


def _kernels(fn):
    """Names of the CUDA kernels that `fn` runs."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# the flagship's training BNs at batch 16: the stem, layer1 and the head,
# layer4
CARD_SHAPES = [(16, 64, 128, 128), (16, 256, 64, 64), (16, 2048, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_on_the_card_cudnn_gives_the_output_and_the_statistics(device, shape):
    x = _input(shape, torch.float32, "channels_last", device=device)
    x[:, 0] = 7.25  # a constant channel
    bn = _bn(shape[1], torch.float32, device=device)
    _assert_equals_f_batch_norm(bn, x)
    xs = [x, _input(shape, torch.float32, "channels_last", device=device, seed=1)]
    bn = _bn(shape[1], torch.float32, device=device)
    for t in xs:
        bn(t)
    mean, var = _reference_running(bn, xs)
    torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=0)
    torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=0)
    once = _bn(shape[1], torch.float32, momentum=1.0, device=device)
    once(x)
    assert once.running_var[0].item() >= 0

    names = _kernels(lambda: bn(x))
    assert any("batchnorm" in n for n in names), names
    assert not any("reduce_kernel" in n for n in names), names
    control = _kernels(lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0))
    assert any("reduce_kernel" in n for n in control), control
