"""The ResNet-152 recipes' pieces that no other port test runs: the
MULTITEST eval and the R-152 trunk, each against the JAX package.

MULTITEST: the tiny flagship (`flagship_cfg(tiny=True)`: epipolarposeR-18,
32 px, 8x8 heatmaps, 5 joints, K=4) with EPIPOLAR.MULTITEST on, one
synthetic view group as the batch (each view a target), and O = 2 or 3
candidate other views, the group's views rolled by 1..O.  The port's
`_multitest_forward` against the JAX `ModelBuilder._multitest_forward`
(XLA matmul attention) on the same randomized weights, f32, with
tests/test_torch_slice.py's tolerances; and the port's pick against the
best of its own single-candidate eval runs.

R-152: poseR-152 at 64 px, batch 1, eval mode, on randomized JAX weights
carried across, with tests/test_torch_resnet.py's tolerances.  The JAX
variables' shapes come from `jax.eval_shape`, so no init program compiles.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _flagship_cfg
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import PoseResNet as JPoseResNet
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.models.resnet import PoseResNet
from epipolar_transformers_tpu_torch.utils.jax_import import load_jax_variables
from test_torch_resnet import (_cfgs, assert_heatmaps_close, flatten_variables,
                               randomize_variables, to_numpy_tree)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)


def _multitest_inputs(candidates):
    """NHWC JAX inputs: the group's V views as the batch, and `candidates`
    other views, view v's o-th candidate being view v + o + 1 (mod V)."""
    group = next(iter(EvalLoader(SyntheticMultiview(flagship_cfg(tiny=True), is_train=False,
                                                    n_samples=1))))
    img, KRT = group["img"][0], group["KRT"][0]
    rolled = [np.roll(np.arange(len(img)), -(o + 1)) for o in range(candidates)]
    return {"img": img, "KRT": KRT, "other_img": np.stack([img[r] for r in rolled]),
            "other_KRT": np.stack([KRT[r] for r in rolled])}


def _to_port(inputs):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inputs.items()}
    out["img"] = out["img"].permute(0, 3, 1, 2)
    out["other_img"] = out["other_img"].permute(0, 1, 4, 2, 3)
    return out


@pytest.fixture(scope="module")
def weights():
    """Randomized JAX variables of the tiny flagship (the zero-init fusion
    BN's scale too, or the fusion would not reach the heatmaps)."""
    rng = np.random.RandomState(0)
    jmodel = JModelBuilder(_flagship_cfg(tiny=True))
    inputs = {k: jnp.asarray(v[0] if k.startswith("other") else v)
              for k, v in _multitest_inputs(1).items()}
    variables = jax.jit(lambda k: jmodel.init(k, inputs, is_train=False))(jax.random.PRNGKey(0))
    variables = randomize_variables(to_numpy_tree(variables), rng)
    bn = variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]
    bn["scale"] = rng.randn(*bn["scale"].shape).astype(np.float32)
    return variables


def _port_model(variables, multitest: bool):
    cfg = flagship_cfg(tiny=True)
    cfg = cfg.replace(EPIPOLAR=cfg.EPIPOLAR.replace(MULTITEST=multitest))
    model = ModelBuilder(cfg)
    load_jax_variables(model, variables)
    return model.eval()


@pytest.mark.parametrize("candidates", [2, 3])
def test_multitest_matches_jax(weights, candidates):
    jcfg = _flagship_cfg(tiny=True)
    jcfg = jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(MULTITEST=True))
    jmodel = JModelBuilder(jcfg)
    inputs = _multitest_inputs(candidates)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, is_train=False)[2])(
        weights, {k: jnp.asarray(v) for k, v in inputs.items()})
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    with torch.no_grad():
        got = _port_model(weights, True)(_to_port(inputs))
    assert set(got) == set(want) == {"heatmap_pred", "batch_locs", "score_pred"}
    assert got["batch_locs"].shape == (len(inputs["img"]), 5, 2)
    assert_heatmaps_close(got["heatmap_pred"].numpy(), want["heatmap_pred"].transpose(0, 3, 1, 2),
                          err_msg="heatmap_pred")
    assert_heatmaps_close(got["score_pred"].numpy(), want["score_pred"], err_msg="score_pred")
    np.testing.assert_allclose(got["batch_locs"].numpy(), want["batch_locs"], rtol=1e-4,
                               atol=1e-3, err_msg="batch_locs")


def test_multitest_keeps_each_joints_most_confident_candidate(weights):
    inputs = _multitest_inputs(3)
    port = _to_port(inputs)
    single = _port_model(weights, False)
    runs = []
    with torch.no_grad():
        for o in range(3):
            runs.append(single({"img": port["img"], "KRT": port["KRT"],
                                "other_img": port["other_img"][o],
                                "other_KRT": port["other_KRT"][o]}))
        got = _port_model(weights, True)(port)
    scores = torch.stack([r["score_pred"] for r in runs])
    best = scores.argmax(0)
    assert best.unique().numel() > 1  # the pick is not one candidate throughout
    torch.testing.assert_close(got["score_pred"], scores.max(0).values, rtol=0, atol=0)
    locs = torch.stack([r["batch_locs"] for r in runs])
    torch.testing.assert_close(got["batch_locs"],
                               torch.gather(locs, 0, best[None, ..., None].expand(1, -1, -1, 2))[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["heatmap_pred"], runs[-1]["heatmap_pred"], rtol=0, atol=0)


def test_resnet152_trunk_matches_jax(rng):
    cfg, jcfg = _cfgs("152")
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jmodel = JPoseResNet(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.asarray(x), train=False),
                            jax.random.PRNGKey(0))
    variables = randomize_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes), rng)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))

    model = PoseResNet(cfg).eval()
    assert [len(getattr(model, f"layer{i}")) for i in range(1, 5)] == [3, 8, 36, 3]
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert_heatmaps_close(got.heatmaps[-1].numpy(),
                          np.asarray(want.heatmaps[-1]).transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4 * float(np.abs(want.features).max()))
