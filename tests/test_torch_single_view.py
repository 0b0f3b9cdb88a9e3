"""The single-view `keypoint` task, and every task of the slice end to end,
in the port on the CPU.

  * `keypoint` (poseR-18, 64 px, 5 joints, batch 2 synthetic train items):
    one train step against the JAX `loss_fn` in f64 (the JAX convolutions
    patched to f64): the loss (rtol 1e-5), every gradient (rtol 1e-4, atol
    1e-4 x its max) and the BN running statistics after the step (rtol
    1e-5, atol 1e-5 x their max; flax's biased-variance update, ROADMAP
    C3); the eval outputs (heatmaps, decoded peaks and scores) in f32
    against the JAX eval forward (heatmaps rtol 1e-4 with atol 1e-4 x
    their max, as tests/test_torch_resnet.py holds PoseResNet; peaks
    within 1e-3 px);
  * `keypoint` through `train` and `test()` on the synthetic rig (the JAX
    package's tests/test_train_loop.py setting): finite MPJPE, JDR and PCK
    under pymvg; an epipolar triangulation mode raises, as the JAX tester
    fails on the missing `corr_pos`;
  * each of the eight tasks builds, trains a step and evaluates;
  * the classifier ResNet (R-18, 64 px) in train-mode BN against JAX's: the
    pooled features (rtol 1e-4, atol 1e-5) and the moved running
    statistics; keypoint_lifting_direct's backbone BN on running statistics
    in a port train step, with gradients.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import resnet as jresnet
from epipolar_transformers_tpu.models.resnet import ResNet as JResNet
from epipolar_transformers_tpu_torch.config import update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import test as port_test
from epipolar_transformers_tpu_torch.engine import train, trainer
from epipolar_transformers_tpu_torch.engine.tester import EVAL_KEYS, MODEL_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.models.resnet import ResNet
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_hourglass import _random_variables
from test_torch_lifting import TASKS, _port_f64, task_case
from test_torch_resnet import flatten_variables, randomize_variables, to_numpy_tree
from torch_configs import config_pair, one_torch_thread  # noqa: F401

BATCH = 2


def _keypoint_cfgs(**extra):
    """(port config, JAX config) of the keypoint task on the synthetic rig
    (tests/test_train_loop.py's setting, 64 px)."""
    return config_pair({
        "DATASETS": {"TRAIN": ("synthetic_multiview_train",),
                     "TEST": ("synthetic_multiview_val",), "TASK": "keypoint",
                     "IMAGE_SIZE": (64, 64), "IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0},
        "BACKBONE": {"ENABLED": True, "BODY": "poseR-18", "DOWNSAMPLE": 4,
                     "PRETRAINED": False},
        "KEYPOINT": {"ENABLED": True, "NUM_PTS": 5, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0,
                     "LOSS": "joint", "LOSS_PER_JOINT": False, "TRIANGULATION": "pymvg"},
        "SOLVER": {"OPTIMIZER": "adam", "BASE_LR": 1e-3, "IMS_PER_BATCH": BATCH,
                   "MAX_EPOCHS": 1},
        "TEST": {"IMS_PER_BATCH": 1}, "TENSORBOARD": {"USE": False}, **extra})


def _train_batch(cfg):
    np.random.seed(0)  # the train items draw their reference view from it
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=BATCH, seed=0)
    return collate([ds[i] for i in range(BATCH)])


@pytest.fixture(scope="module")
def keypoint_pair():
    """The JAX keypoint model's random variables, and the port's model
    carrying them."""
    cfg, jcfg = _keypoint_cfgs()
    batch = _train_batch(cfg)
    jmodel = JModelBuilder(jcfg)
    jinputs = {k: jnp.asarray(batch[k]) for k in MODEL_KEYS if k in batch}
    variables = randomize_variables(_random_variables(
        lambda k: jmodel.init(k, jinputs, is_train=False), np.random.RandomState(1)),
        np.random.RandomState(2))
    model = ModelBuilder(cfg)
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    return cfg, jmodel, variables, model, batch


def test_keypoint_train_step_matches_jax(monkeypatch, keypoint_pair):
    cfg, jmodel, variables, model, batch = keypoint_pair
    monkeypatch.setattr(jresnet, "compute_dtype", lambda c: jnp.float64)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    jinputs = {k: jnp.asarray(np.asarray(batch[k], np.float64)
                              if np.asarray(batch[k]).dtype.kind == "f" else batch[k])
               for k in MODEL_KEYS if k in batch}

    def loss_fn(params, batch_stats):
        (loss_dict, _, _), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, jinputs, is_train=True,
            mutable=["batch_stats"])
        return loss_dict["loss"], mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v64["params"], v64["batch_stats"])

    port = ModelBuilder(cfg)
    port.load_state_dict(model.state_dict())
    port = _port_f64(port).train()
    inputs = to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS)
    loss_dict, metric_dict, out = port({k: v.double() if v.is_floating_point() else v
                                        for k, v in inputs.items()})
    assert set(loss_dict) == {"loss"} and metric_dict == {} and set(out) == {"heatmap_pred"}
    loss_dict["loss"].backward()
    np.testing.assert_allclose(loss_dict["loss"].item(), float(jloss), rtol=1e-5)
    want = jax_state_dict(port, to_numpy_tree({"params": jgrads, "batch_stats": jstats}))[0]
    for k, p in port.named_parameters():
        w = want[k].double().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=k)
    for k, v in port.state_dict().items():
        if "running" in k:
            w = want[k].double().numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=k)


def test_keypoint_eval_outputs_match_jax(keypoint_pair):
    cfg, jmodel, variables, model, _ = keypoint_pair
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    group = {k: v for k, v in ds[0].items()}
    want = jax.jit(lambda v, x: jmodel.apply(v, x, is_train=False)[2])(
        variables, {k: jnp.asarray(group[k]) for k in ("img", "KRT")})
    with torch.no_grad():
        got = model.eval()(to_model_inputs(group, torch.device("cpu"), EVAL_KEYS))
    assert set(got) == {"heatmap_pred", "batch_locs", "score_pred"} <= set(want)
    w = np.asarray(want["heatmap_pred"]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got["heatmap_pred"].numpy(), w, rtol=1e-4,
                               atol=1e-4 * float(np.abs(w).max()))
    np.testing.assert_allclose(got["batch_locs"].numpy(), np.asarray(want["batch_locs"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["score_pred"].numpy(), np.asarray(want["score_pred"]),
                               rtol=1e-4, atol=1e-6)


def test_keypoint_trains_and_tests_on_the_rig(tmp_path):
    cfg, _ = _keypoint_cfgs(OUTPUT_DIR=str(tmp_path))
    model, optimizer = train(cfg, max_steps=2, device="cpu")
    assert optimizer.count == 2
    results = port_test(cfg, model, max_batches=2)
    assert {"EPEmean_global", "MPJPE@action0", "JDR"} <= set(results)
    assert any(k.startswith("PCK@") for k in results)
    assert all(math.isfinite(v) for v in results.values()), results
    for mode in ("epipolar", "epipolar_dlt"):
        with pytest.raises(ValueError, match="corr_pos"):
            port_test(update_from_dict(cfg, {"KEYPOINT": {"TRIANGULATION": mode}}), model,
                      max_batches=1)


@pytest.mark.parametrize("task", ["keypoint"] + TASKS)
def test_each_task_trains_a_step_and_evaluates(task):
    if task == "keypoint":
        cfg, _ = _keypoint_cfgs()
        batch = _train_batch(cfg)
    else:
        cfg, _, batch = task_case(task)
    model = trainer.build_model(cfg, torch.device("cpu"))
    step = trainer.make_train_step(cfg, model, trainer.make_optimizer(cfg, model))
    inputs = to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS)
    metrics = step(inputs)
    assert "loss" in metrics and all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    model.eval()
    with torch.no_grad():
        out = model(inputs)
    if task == "keypoint":
        assert out["batch_locs"].shape == (BATCH, cfg.KEYPOINT.NUM_PTS, 2)
        return
    loss_dict, metric_dict, out = out
    assert "EPEmean_can" in metric_dict and ("EPEmean" in metric_dict) == ("rot" in task)
    assert out["can_pred"].shape == (BATCH, cfg.KEYPOINT.NUM_PTS, 3)
    assert all(math.isfinite(float(v)) for v in {**loss_dict, **metric_dict}.values())


def test_classifier_resnet_matches_jax_in_train_mode():
    """R-18 at 64 px, BN on batch statistics: the pooled features and the
    moved running statistics."""
    cfg, jcfg = config_pair({"BACKBONE": {"BODY": "R-18"}})
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jnet = JResNet(jcfg, depth="18")
    variables = randomize_variables(_random_variables(
        lambda k: jnet.init(k, x, train=False), rng), rng)
    want, mutated = jnet.apply(variables, x, train=True, mutable=["batch_stats"])
    net = ResNet(cfg)
    assert net.out_channels == 512
    assert load_jax_variables(net, variables) == flatten_variables(variables)
    got = net.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    moved = jax_state_dict(net, to_numpy_tree({**variables, **mutated}))[0]
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_keypoint_lifting_direct_backbone_bn_stays_on_running_stats():
    cfg, _, batch = task_case("keypoint_lifting_direct")
    model = trainer.build_model(cfg, torch.device("cpu"))
    assert model.training and not model.backbone.training
    assert not any(m.training for m in model.backbone.modules())
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    optimizer = trainer.make_optimizer(cfg, model)
    trainer.make_train_step(cfg, model, optimizer)(
        to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS))
    assert model.backbone.conv1.weight.grad is not None
    assert float(model.backbone.conv1.weight.grad.abs().max()) > 0
    for k, v in model.backbone.state_dict().items():
        if "running" in k or "num_batches" in k:
            assert torch.equal(v, before[k]), k
    model.eval().train()
    assert not model.backbone.training
