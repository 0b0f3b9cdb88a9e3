"""utils/profiling.py against the JAX package's: `profile_model`'s
parameter count equals the JAX count exactly (the tiny flagship, and a
poseR-50 `keypoint` config at 64 px); its convolution FLOPs equal an
analytic count over the model's convolutions; its total agrees with XLA's
`cost_analysis` of the JAX forward on the `keypoint` config (no attention)
within the band XLA_OVER_PORT, around XLA's 0.8676x the port's count
(measured here).  Both differences are in the count, not the work:
FlopCounterMode counts a transposed convolution as every input pixel
times its whole kernel, the contributions that its padding crops off the
output included, where XLA counts the valid taps only (at 64 px the deconv
head's first layer maps 2x2 to 4x4 and crops more than half of them; at
the recipes' sizes a few percent); and XLA also counts the elementwise
work (BatchNorm, ReLU, the adds), which FlopCounterMode leaves out.  The
attention counts by formula: the same total with the plain route's ops as
with a stand-in that dispatches none.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_configs import config_pair, one_torch_thread  # noqa: E402,F401

from epipolar_transformers_tpu.utils import profiling as jax_profiling  # noqa: E402
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar  # noqa: E402
from epipolar_transformers_tpu_torch.utils import profiling  # noqa: E402

KEYPOINT = {"DATASETS": {"TASK": "keypoint", "IMAGE_SIZE": (64, 64)},
            "BACKBONE": {"BODY": "poseR-50"}, "KEYPOINT": {"NUM_PTS": 17, "HEATMAP_SIZE": (16, 16)}}
# XLA's count of the keypoint forward over the port's (0.8676 measured):
# the deconv head's cropped taps, less the elementwise work
XLA_OVER_PORT = (0.85, 0.89)


@pytest.fixture(scope="module")
def keypoint():
    cfg, jcfg = config_pair(KEYPOINT)
    return cfg, profiling.profile_model(cfg, device="cpu"), jax_profiling.profile_model(jcfg)


@pytest.fixture(scope="module")
def flagship():
    cfg, jcfg = config_pair(tiny_flagship=True)
    return cfg, profiling.profile_model(cfg, device="cpu"), jax_profiling.profile_model(jcfg)


@pytest.mark.parametrize("which", ["flagship", "keypoint"])
def test_params_equal_jax(which, request):
    _, port, jax_side = request.getfixturevalue(which)
    assert port["params"] == jax_side["params"]


def test_conv_flops_equal_an_analytic_count(keypoint):
    """2 x (multiply-adds) of every Conv2d and ConvTranspose2d at the
    shapes a forward hook sees."""
    from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
    from epipolar_transformers_tpu_torch.data.pipeline import collate
    from epipolar_transformers_tpu_torch.engine.tester import MODEL_KEYS, to_model_inputs
    from epipolar_transformers_tpu_torch.engine.trainer import build_model

    cfg, port, _ = keypoint
    model = build_model(cfg, torch.device("cpu")).eval()
    total = []

    def hook(m, args, out):
        x = args[0]
        k = m.kernel_size[0] * m.kernel_size[1] // m.groups
        if isinstance(m, torch.nn.ConvTranspose2d):
            total.append(2 * x.numel() * m.out_channels * k)
        else:
            total.append(2 * out.numel() * m.in_channels * k)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=1, device_render=False)
    with torch.inference_mode():
        model(to_model_inputs(collate([ds[0]]), torch.device("cpu"), MODEL_KEYS))
    assert port["conv_flops"] == sum(total) > 0
    assert port["attention_flops"] == 0


def test_total_agrees_with_xla_cost_analysis(keypoint):
    _, port, jax_side = keypoint
    ratio = jax_side["flops"] / port["flops"]
    assert XLA_OVER_PORT[0] <= ratio <= XLA_OVER_PORT[1], ratio
    assert port["flops"] >= port["conv_flops"]
    assert port["bytes_accessed"] != port["bytes_accessed"]  # NaN: not counted


def test_attention_counts_by_formula(flagship, monkeypatch):
    """On the plain route (the CPU) the attention's own ops leave the count
    and 2*B*H*W*K*(Cq + Cv) takes their place: the total equals the one
    with a stand-in attention that dispatches no FLOPs."""
    cfg, port, _ = flagship
    h, w = cfg.KEYPOINT.HEATMAP_SIZE
    c = cfg.KEYPOINT.NFEATS
    assert port["attention_flops"] == 2 * 1 * h * w * cfg.EPIPOLAR.SAMPLESIZE * (c + c)

    def no_flops(self, q, k, v, sample_locs, prior=None):
        n, hh, ww, _ = q.shape
        return v.clone(), torch.zeros(n, hh, ww, 2), torch.zeros(n, 1, hh, ww)

    monkeypatch.setattr(Epipolar, "attend", no_flops)
    stand_in = profiling.profile_model(cfg, device="cpu")
    assert stand_in["flops"] == port["flops"]
    assert stand_in["attention_flops"] == port["attention_flops"]


def test_stage_times_ship_and_merge():
    a, b = profiling.StageTimes(), profiling.StageTimes()
    a.add("read", 0.5)
    a.add("read", 0.25)
    a.add("warp", 0.1)
    taken = a.take()
    assert a.take() is None and taken == {"read": (0.75, 2), "warp": (0.1, 1)}
    b.add("read", 0.25)
    b.merge(taken)
    assert b.averages() == {"read": 1.0 / 3, "warp": 0.1}
    assert b.report() == "read=333.33ms  warp=100.00ms"
