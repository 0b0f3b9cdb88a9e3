"""The slice end to end: the tiny flagship config (`_flagship_cfg(tiny=True)`:
epipolarposeR-18, 32 px, 8x8 heatmaps, 5 joints, K=4) through the port's
`engine.tester.predict` and through the JAX `ModelBuilder` with
ATTENTION_IMPL 'pallas' (the kernel, interpret mode) and 'auto' (the XLA
matmul path), on the same randomized weights and the same synthetic view
groups.  The zero-init `epipolar_sampler.bn` is randomized too, or the `z`
path would be invisible.

Tolerances (f32 on both sides): heatmap_pred rtol 1e-4 with atol 1e-4 x its
scale; score_pred likewise; batch_locs 1e-3 px; corr_pos 2e-3 px (the
sample locations agree to ~1e-5 normalized, and corr_pos is a location);
depth 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, predict, to_model_inputs
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils.jax_import import load_jax_variables
from test_torch_resnet import (assert_heatmaps_close, flatten_variables, randomize_variables,
                               to_numpy_tree)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

EVAL_KEYS = ("img", "KRT", "other_img", "other_KRT")


def _setup(impl, rng):
    cfg = _flagship_cfg(tiny=True)
    cfg = cfg.replace(EPIPOLAR=cfg.EPIPOLAR.replace(ATTENTION_IMPL=impl))
    ds = SyntheticMultiview(flagship_cfg(tiny=True), is_train=False, n_samples=2)
    groups = list(EvalLoader(ds))
    jmodel = JModelBuilder(cfg)
    inputs0 = {k: jnp.asarray(groups[0][k][0]) for k in EVAL_KEYS}
    variables = jax.jit(lambda k: jmodel.init(k, inputs0, is_train=False))(jax.random.PRNGKey(0))
    variables = randomize_variables(to_numpy_tree(variables), rng)
    bn = variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]
    bn["scale"] = rng.randn(*bn["scale"].shape).astype(np.float32)
    return cfg, groups, jmodel, variables


@pytest.fixture(scope="module")
def jax_runs():
    """JAX outputs for both impls, on the same weights (one init); the
    port's config beside them."""
    rng = np.random.RandomState(0)
    cfg, groups, jmodel, variables = _setup("pallas", rng)
    runs = {}
    for impl in ("pallas", "auto"):
        c = cfg.replace(EPIPOLAR=cfg.EPIPOLAR.replace(ATTENTION_IMPL=impl))
        m = JModelBuilder(c)
        step = jax.jit(lambda v, x: m.apply(v, x, is_train=False)[2])
        runs[impl] = [{k: np.asarray(v, np.float32) for k, v in step(
            variables, {k: jnp.asarray(g[k][0]) for k in EVAL_KEYS}).items()} for g in groups]
    return flagship_cfg(tiny=True), groups, variables, runs


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_slice_matches_jax(jax_runs, impl):
    cfg, groups, variables, runs = jax_runs
    model = ModelBuilder(cfg)
    load_jax_variables(model, variables)
    outs = predict(cfg, model, groups)
    assert len(outs) == len(groups)
    for got, want in zip(outs, runs[impl]):
        assert set(got) == set(want)
        assert_heatmaps_close(got["heatmap_pred"].numpy(),
                              want["heatmap_pred"].transpose(0, 3, 1, 2), err_msg="heatmap_pred")
        assert_heatmaps_close(got["score_pred"].numpy(), want["score_pred"], err_msg="score_pred")
        np.testing.assert_allclose(got["batch_locs"].numpy(), want["batch_locs"],
                                   rtol=0, atol=1e-3, err_msg="batch_locs")
        np.testing.assert_allclose(got["corr_pos"].numpy(), want["corr_pos"],
                                   rtol=0, atol=2e-3, err_msg="corr_pos")
        np.testing.assert_allclose(got["depth"].numpy(), want["depth"],
                                   rtol=1e-4, atol=1e-4, err_msg="depth")


def test_bridge_uses_every_key_both_ways(jax_runs):
    """Every port key receives a JAX leaf (strict load) and every JAX leaf
    is used, including the ZeroInitBatchNorm's nested `norm`."""
    _, _, variables, _ = jax_runs
    model = ModelBuilder(flagship_cfg(tiny=True))
    used = load_jax_variables(model, variables)
    assert used == flatten_variables(variables)
    assert ("params", "reference", "epipolar_sampler", "bn", "norm", "scale") in used
    np.testing.assert_array_equal(
        model.reference.epipolar_sampler.bn.weight.detach().numpy(),
        variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]["scale"])


def test_fused_trunk_equals_two_passes(jax_runs, monkeypatch):
    cfg, groups, variables, _ = jax_runs
    model = ModelBuilder(flagship_cfg(tiny=True))
    load_jax_variables(model, variables)
    fused = predict(cfg, model, groups[:1])[0]
    monkeypatch.setattr(ModelBuilder, "_can_fuse_trunks", lambda self, bn_train=False: False)
    two = predict(cfg, model, groups[:1])[0]
    for k in fused:
        np.testing.assert_allclose(fused[k].numpy(), two[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_flagship_cfg_is_the_graft_entry_config():
    """The two packages' flagship trees agree field by field."""
    for tiny in (True, False):
        assert dataclasses.asdict(flagship_cfg(tiny)) == dataclasses.asdict(_flagship_cfg(tiny))


@pytest.mark.parametrize("override,error,match", [
    ({"EPIPOLAR": {"ATTENTION_IMPL": "matmul", "POOLING": True}}, ValueError, "does not support"),
    ({"EPIPOLAR": {"ATTENTION_IMPL": "pallas", "SIMILARITY": "cos"}}, ValueError,
     "does not support"),
    ({"EPIPOLAR": {"MERGE": "early", "BOTTLENECK": 2}}, ValueError, "BOTTLENECK"),
    ({"EPIPOLAR": {"PRIOR": True}}, ValueError, "CAMERAS"),
    ({"DATASETS": {"TASK": "no_such_task"}}, NotImplementedError, "no_such_task"),
], ids=["impl", "cos", "merge", "prior", "task"])
def test_unported_configs_raise(override, error, match):
    """What the port refuses when the model is built: a forced attention
    impl that cannot express the config (where the JAX layer raises), a
    bottleneck without theta/phi/g, a prior table without cameras, and a
    task that neither package has."""
    from epipolar_transformers_tpu_torch.config import update_from_dict

    with pytest.raises(error, match=match):
        ModelBuilder(update_from_dict(flagship_cfg(tiny=True), override))


def test_training_raises():
    """What has no training path raises in train mode: the forward-only
    'pallas' impl (as in the JAX layer) and 'dots_bf16' remat (C-traps)."""
    from epipolar_transformers_tpu_torch.config import update_from_dict

    ds = SyntheticMultiview(flagship_cfg(tiny=True), is_train=False, n_samples=1)
    group = {k: v[0] for k, v in next(iter(EvalLoader(ds))).items()}
    inputs = to_model_inputs(group, "cpu", TRAIN_KEYS)
    for override, error, match in (
        ({"ATTENTION_IMPL": "pallas"}, ValueError, "forward-only"),
        ({"ATTENTION_REMAT": "dots_bf16"}, NotImplementedError, "dots_bf16"),
    ):
        cfg = update_from_dict(flagship_cfg(tiny=True), {"EPIPOLAR": override})
        model = ModelBuilder(cfg)
        with torch.no_grad():
            model.eval()(inputs)  # eval is unaffected
        with pytest.raises(error, match=match):
            model.train()(inputs)
