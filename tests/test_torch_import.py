"""Torch checkpoint import: numeric layer-level parity + end-to-end
PoseResNet import of a torch-style state dict."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from flax import linen as nn

torch = pytest.importorskip("torch")

from epipolar_transformers_tpu.config import Config, update_from_dict
from epipolar_transformers_tpu.models import PoseResNet
from epipolar_transformers_tpu.utils.torch_import import (
    convert_state_dict,
    load_into_variables,
    strip_prefix,
    torch_key_to_flax_path,
)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)


def test_conv_conversion_numeric(rng):
    tconv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=True)
    x = rng.randn(1, 7, 7, 3).astype(np.float32)
    with torch.no_grad():
        ref = tconv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    k = np.transpose(tconv.weight.detach().numpy(), (2, 3, 1, 0))
    b = tconv.bias.detach().numpy()
    fconv = nn.Conv(5, (3, 3), padding=1)
    out = fconv.apply({"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}},
                      jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), ref.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-5)


def test_deconv_conversion_numeric(rng):
    """torch ConvTranspose2d(4,4,stride 2,pad 1) == flax ConvTranspose SAME
    with the (2,3,0,1)-transposed, spatially-flipped kernel."""
    tconv = torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1, bias=False)
    x = rng.randn(1, 5, 5, 6).astype(np.float32)
    with torch.no_grad():
        ref = tconv(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    k = np.ascontiguousarray(
        np.transpose(tconv.weight.detach().numpy(), (2, 3, 0, 1))[::-1, ::-1]
    )
    fconv = nn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
    out = fconv.apply({"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x))
    assert out.shape == (1, 10, 10, 4)
    np.testing.assert_allclose(np.asarray(out), ref.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-5)


def test_batchnorm_conversion_numeric(rng):
    tbn = torch.nn.BatchNorm2d(4)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(rng.rand(4).astype(np.float32) + 0.5))
        tbn.bias.copy_(torch.from_numpy(rng.randn(4).astype(np.float32)))
        tbn.running_mean.copy_(torch.from_numpy(rng.randn(4).astype(np.float32)))
        tbn.running_var.copy_(torch.from_numpy(rng.rand(4).astype(np.float32) + 0.5))
    tbn.eval()
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    with torch.no_grad():
        ref = tbn(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    fbn = nn.BatchNorm(use_running_average=True, epsilon=1e-5)
    variables = {
        "params": {"scale": jnp.asarray(tbn.weight.detach().numpy()),
                   "bias": jnp.asarray(tbn.bias.detach().numpy())},
        "batch_stats": {"mean": jnp.asarray(tbn.running_mean.numpy()),
                        "var": jnp.asarray(tbn.running_var.numpy())},
    }
    out = fbn.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), ref.transpose(0, 2, 3, 1),
                               rtol=1e-4, atol=1e-5)


def test_key_mapping_rules():
    assert torch_key_to_flax_path("layer1.0.conv1.weight")[0] == ("layer1", "block0", "conv1")
    assert torch_key_to_flax_path("layer3.12.downsample.0.weight")[0] == (
        "layer3", "block12", "downsample_conv")
    assert torch_key_to_flax_path("deconv_layers.0.weight")[0] == ("deconv_layers", "deconv0")
    assert torch_key_to_flax_path("deconv_layers.4.weight")[0] == ("deconv_layers", "bn1")
    assert torch_key_to_flax_path("bn1.running_mean")[2] == "bn_stat"
    assert torch_key_to_flax_path("bn1.num_batches_tracked")[2] == "skip"


def test_strip_prefix():
    """Reference strip_prefix_if_present semantics
    (model_serialization.py:59-76)."""
    # every key prefixed -> stripped
    sd = {"module.conv1.weight": np.zeros(1), "module.bn1.bias": np.ones(1)}
    out = strip_prefix(sd, "module.")
    assert set(out) == {"conv1.weight", "bn1.bias"}
    # mixed prefixes, allow off -> returned UNTOUCHED (ref :62-66)
    sd = {"module.conv1.weight": np.zeros(1), "other": np.ones(1)}
    with pytest.warns(UserWarning, match="prefix"):
        out = strip_prefix(sd, "module.")
    assert set(out) == {"module.conv1.weight", "other"}
    # mixed prefixes, WEIGHTS_ALLOW_DIFF_PREFIX -> non-matching dropped,
    # matching stripped (ref :69-71)
    with pytest.warns(UserWarning, match="prefix"):
        out = strip_prefix(sd, "module.", allow_diff_prefix=True)
    assert set(out) == {"conv1.weight"}
    # empty prefix + replacement -> replacement PREPENDED (ref :72-73)
    out = strip_prefix({"a.b": np.zeros(1)}, "", "backbone.")
    assert set(out) == {"backbone.a.b"}


def _tiny_torch_posenet_sd(rng, num_pts=5):
    """Hand-built torch-style state dict for poseR-18's first pieces +
    deconv + final — enough to verify end-to-end import."""
    sd = {}
    def conv(k, o, i, s=3):
        sd[k + ".weight"] = rng.randn(o, i, s, s).astype(np.float32) * 0.05
    def bn(k, c):
        sd[k + ".weight"] = rng.rand(c).astype(np.float32) + 0.5
        sd[k + ".bias"] = rng.randn(c).astype(np.float32) * 0.1
        sd[k + ".running_mean"] = rng.randn(c).astype(np.float32) * 0.1
        sd[k + ".running_var"] = rng.rand(c).astype(np.float32) + 0.5
        sd[k + ".num_batches_tracked"] = np.int64(1)
    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    for L, (cin, cout, blocks) in {"layer1": (64, 64, 2), "layer2": (64, 128, 2),
                                   "layer3": (128, 256, 2), "layer4": (256, 512, 2)}.items():
        for b in range(blocks):
            ci = cin if b == 0 else cout
            conv(f"{L}.{b}.conv1", cout, ci)
            bn(f"{L}.{b}.bn1", cout)
            conv(f"{L}.{b}.conv2", cout, cout)
            bn(f"{L}.{b}.bn2", cout)
            if b == 0 and L != "layer1":
                conv(f"{L}.{b}.downsample.0", cout, ci, 1)
                bn(f"{L}.{b}.downsample.1", cout)
    for i in range(3):
        cin = 512 if i == 0 else 256
        sd[f"deconv_layers.{3*i}.weight"] = rng.randn(cin, 256, 4, 4).astype(np.float32) * 0.02
        bn(f"deconv_layers.{3*i+1}", 256)
    sd["final_layer.weight"] = rng.randn(num_pts, 256, 1, 1).astype(np.float32) * 0.02
    sd["final_layer.bias"] = np.zeros(num_pts, np.float32)
    return sd


def test_posenet_end_to_end_import(rng):
    d = {
        "BACKBONE": {"BODY": "poseR-18", "DOWNSAMPLE": 4},
        "KEYPOINT": {"NUM_PTS": 5, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
        "DATASETS": {"IMAGE_SIZE": (64, 64)},
    }
    cfg = update_from_dict(Config(), d)
    model = PoseResNet(cfg)
    x = jnp.zeros((1, 64, 64, 3))
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    sd = {"module." + k: v for k, v in _tiny_torch_posenet_sd(rng).items()}
    new_vars, missing = load_into_variables(variables, sd, prefix="module.")
    # every param leaf except batch-stats-free extras should be matched
    assert missing == [], missing[:10]
    # imported conv1 kernel actually landed (not the init values)
    k_new = np.asarray(new_vars["params"]["conv1"]["kernel"])
    expected = np.transpose(sd["module.conv1.weight"], (2, 3, 1, 0))
    np.testing.assert_allclose(k_new, expected)
    # model still runs
    out = model.apply(new_vars, x, train=False)
    assert np.isfinite(np.asarray(out.heatmaps[0])).all()
