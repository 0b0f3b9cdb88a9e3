"""Port PoseResNet == the JAX PoseResNet on the same weights, and == the
reference's golden activations under the reference's own state dict.

JAX weights are randomized with numpy (He-scaled kernels, random BN
statistics, scales and biases, so that activations stay O(1) and heatmap
peaks are distinct), carried across by utils/jax_import, and both models
run in eval mode in f32.  Tolerance: rtol 1e-4 with atol 1e-4 x the
heatmap's scale, the f32 drift of ~20-50 layers of reassociated sums (the
JAX stem is space-to-depth, the port's a plain 7x7 conv).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.models import PoseResNet as JPoseResNet
from epipolar_transformers_tpu_torch.models.resnet import PoseResNet
from epipolar_transformers_tpu_torch.utils.jax_import import load_jax_variables
from torch_configs import config_pair, one_torch_thread  # noqa: F401 (autouse)


def flatten_variables(variables):
    """All (collection, *path) leaves of a JAX variables tree."""
    out = set()

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, prefix + (k,))
            else:
                out.add(prefix + (k,))

    for coll, tree in variables.items():
        walk(tree, (coll,))
    return out


def to_numpy_tree(tree):
    return {k: to_numpy_tree(v) if hasattr(v, "items") else np.asarray(v, np.float32)
            for k, v in tree.items()}


def randomize_variables(variables, rng):
    """Random O(1)-preserving weights for a JAX variables tree (numpy)."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                v = rng.randn(*v.shape) * np.sqrt(1.0 / fan_in)
            elif k == "scale":
                v = rng.uniform(0.3, 0.6, v.shape)
            elif k == "bias":
                v = 0.1 * rng.randn(*v.shape)
            elif k == "mean":
                v = 0.1 * rng.randn(*v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "prior":
                continue
            out[k] = np.asarray(v, np.float32)
        return out
    return {coll: walk(tree) for coll, tree in variables.items()}


def assert_heatmaps_close(got, want, rtol=1e-4, atol_scale=1e-4, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * float(np.abs(want).max()), err_msg=err_msg)


def _cfgs(depth):
    """(port config, JAX config) of a poseR-`depth` at 64 px."""
    return config_pair({
        "BACKBONE": {"BODY": f"poseR-{depth}", "DOWNSAMPLE": 4},
        "KEYPOINT": {"NUM_PTS": 5, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
        "DATASETS": {"IMAGE_SIZE": (64, 64)},
    })


@pytest.mark.parametrize("depth", ["18", "50"])
def test_poseresnet_matches_jax(rng, depth):
    cfg, jcfg = _cfgs(depth)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmodel = JPoseResNet(jcfg)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.asarray(x), train=False))(jax.random.PRNGKey(0))
    variables = randomize_variables(to_numpy_tree(variables), rng)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))

    model = PoseResNet(cfg).eval()
    used = load_jax_variables(model, variables)
    assert used == flatten_variables(variables)  # every JAX leaf carried across
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert_heatmaps_close(got.heatmaps[-1].numpy(),
                          np.asarray(want.heatmaps[-1]).transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4 * float(np.abs(want.features).max()))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want.scores).max()))
    np.testing.assert_allclose(got.locs.numpy(), np.asarray(want.locs), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("depth,hm_atol", [("18", 1e-4), ("50", 2e-3)])
def test_poseresnet_loads_reference_state_dict(depth, hm_atol):
    """The reference's own torch state dict loads into the port with
    strict=True (same child names) and reproduces its saved heatmaps, with
    the bounds of the JAX package's golden test (tests/test_golden_parity.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_golden_fixtures",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "make_golden_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             f"poseresnet{depth}_golden.npz"))
    sd = {}
    for key, shape_s in zip(g["sd_keys"], g["sd_shapes"]):
        shape = tuple(int(s) for s in str(shape_s).split("x")) if str(shape_s) else ()
        sd[str(key)] = torch.as_tensor(np.asarray(mod.det_tensor(str(key), shape)))
    model = PoseResNet(_cfgs(depth)[0]).eval()
    sd = {k: v.to(model.state_dict()[k].dtype) for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]))
    np.testing.assert_allclose(out.heatmaps[-1].numpy(), g["heatmap"], rtol=1e-3, atol=hm_atol)
    np.testing.assert_allclose(out.scores.numpy(), g["batch_scos"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.locs.numpy(), g["batch_locs"], rtol=1e-3, atol=5e-3)
