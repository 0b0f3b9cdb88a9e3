"""The port's lifting tasks == the JAX package's.

Module by module, the same seeded inputs through the JAX function and the
port's counterpart:
  * data/transforms/keypoints3d.py: equal to JAX to 1e-12, and to
    keypoints3d_golden.npz at the JAX test's tolerances;
  * metrics/metrics3d.py: epe_mean (its faithful quirk: the mean over all
    joints, visibility zeroing only the per-joint array) and the multiview
    upper bound, to 1e-6;
  * LiftingNet per task against the flax module at rtol 1e-4, atol 1e-5 (the
    JAX weights carried across by utils/jax_import, whose fc0 column
    permutation takes JAX's NHWC flatten to the port's NCHW one, at a
    heatmap size the pool-8 windows do not divide, which pins the floored
    pool), and against lifting_golden.npz with the reference-layout state
    dict loaded as it is;
  * per task, the ModelBuilder's losses, metrics, eval outputs and every
    gradient against `jax.grad` of the JAX ModelBuilder in eval semantics
    (is_train=False on both sides: dropout off, BN on running statistics),
    in f64 (the JAX convolutions patched to f64, the attention through its
    f64 oracle on JAX's sample locations), which also holds each task's
    parameter set to JAX's (keypoint_lifting_rot builds no backbone);
  * multiview_img_lifting_rot's stop-gradient on the other view; the VIS.MULTIVIEW fusion (mean, lower median, upper bound)
    against tests/test_lifting_e2e.py's JAX setup; two seeded train steps
    bit-equal, the dropout drawing nothing from the global RNG.
"""

import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.nn import functional as F

from epipolar_transformers_tpu.data.transforms import keypoints3d as jk3d
from epipolar_transformers_tpu.engine import create_train_state
from epipolar_transformers_tpu.metrics import metrics3d as jm3d
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import epipolar as jepipolar
from epipolar_transformers_tpu.models import resnet as jresnet
from epipolar_transformers_tpu.models.lifting import LiftingNet as JLiftingNet
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.data.transforms import keypoints3d as k3d
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.tester import MODEL_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.metrics import metrics3d as m3d
from epipolar_transformers_tpu_torch.models import ModelBuilder, epipolar
from epipolar_transformers_tpu_torch.models.lifting import LiftingNet, conv_out_size
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
import test_lifting_e2e
from test_lifting_e2e import _multiview_lifting_setup
from test_torch_hourglass import _random_variables
from test_torch_resnet import flatten_variables, randomize_variables, to_numpy_tree
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
N, J = 2, 21
# 76 x 84 heatmaps: the pool-8 windows leave 4 rows and 4 columns over
# (floored to 9 x 10, ceil_mode would give 10 x 11), and the conv stacks end
# at 2 x 2 (pool 8) and 5 x 6 (pool 2), so fc0's permutation moves rows
HM = (76, 84)


def _det_tensor():
    spec = importlib.util.spec_from_file_location(
        "make_golden_fixtures",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "make_golden_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.det_tensor


# ------------------------------------------------------------------ keypoints3d
def test_keypoints3d_match_jax_and_golden():
    rng = np.random.RandomState(0)
    for _ in range(5):
        pts42 = rng.randn(42, 3)
        np.testing.assert_allclose(k3d.palm_coord(pts42), jk3d.palm_coord(pts42),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(k3d.palm_coord_singlehand(pts42[:21]),
                                   jk3d.palm_coord_singlehand(pts42[:21]), rtol=0, atol=1e-12)
        np.testing.assert_allclose(k3d.flip_hand(pts42), jk3d.flip_hand(pts42), rtol=0, atol=0)
        hand = pts42[:21] - pts42[0]
        for got, want in zip(k3d.canonical_trafo(hand), jk3d.canonical_trafo(hand)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for y, x in [(1.0, 2.0), (-1.0, 2.0), (1.0, -2.0), (-1.0, -2.0), (0.0, 0.0), (3.0, -1e-9)]:
        assert abs(k3d.atan2(y, x) - jk3d.atan2(y, x)) <= 1e-12

    g = np.load(os.path.join(FIXTURES, "keypoints3d_golden.npz"))
    np.testing.assert_allclose(k3d.palm_coord(g["pts42"]), g["palm"], rtol=1e-10, atol=1e-10)
    canonical, rot = k3d.canonical_trafo(g["coords"].copy())
    np.testing.assert_allclose(canonical, g["canonical"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rot, g["rot"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(k3d.flip_hand(g["coords"].copy()), g["flipped"],
                               rtol=1e-6, atol=1e-8)


# -------------------------------------------------------------------- metrics3d
@pytest.mark.parametrize("case", ["scalars", "per_sample", "vis3", "clamped", "no_vis"])
def test_epe_mean_matches_jax(case):
    rng = np.random.RandomState(["scalars", "per_sample", "vis3", "clamped", "no_vis"].index(case))
    out, target = rng.randn(4, J, 3), rng.randn(4, J, 3)
    vis = (rng.rand(4, J) > 0.3).astype(np.float64)
    scale, unit = 0.7, 30.0
    if case == "per_sample":
        scale, unit = rng.rand(4) + 0.5, rng.rand(4) * 40
    elif case == "vis3":
        vis = np.repeat(vis[..., None], 3, axis=-1)
    elif case == "clamped":
        unit = 1000.0
    elif case == "no_vis":
        vis, scale, unit = None, None, None
    got = m3d.epe_mean(torch.from_numpy(out), torch.from_numpy(target),
                       None if vis is None else torch.from_numpy(vis),
                       scale if np.isscalar(scale) or scale is None else torch.from_numpy(scale),
                       unit if np.isscalar(unit) or unit is None else torch.from_numpy(unit))
    want = jm3d.epe_mean(jnp.asarray(out), jnp.asarray(target), vis, scale, unit)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


def test_epe_mean_multiview_gt_matches_jax():
    rng = np.random.RandomState(7)
    out, target = rng.randn(4, J, 3), rng.randn(J, 3)
    for vis in ((rng.rand(4, J) > 0.3).astype(np.float64), np.zeros((4, J)), None):
        got = m3d.epe_mean_multiview_gt(torch.from_numpy(out), torch.from_numpy(target),
                                        None if vis is None else torch.from_numpy(vis),
                                        unit=torch.tensor(1000.0, dtype=torch.float64))
        want = jm3d.epe_mean_multiview_gt(jnp.asarray(out), jnp.asarray(target), vis,
                                          unit=1000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ------------------------------------------------------------------- LiftingNet
NET_TASKS = ["lifting", "lifting_direct", "lifting_rot", "keypoint_lifting_rot",
             "keypoint_lifting_direct", "img_lifting_rot", "multiview_img_lifting_rot"]


def _net_cfgs(task, side=True, hm=HM):
    return config_pair({
        "DATASETS": {"TASK": task}, "LIFTING": {"ENABLED": True, "FLIP_ON": True},
        "KEYPOINT": {"NUM_PTS": J, "HEATMAP_SIZE": hm},
        "DATASET_FAMILY": "rhd" if side else ""})


@pytest.mark.parametrize("task", NET_TASKS)
def test_liftingnet_matches_jax(task):
    side = task != "multiview_img_lifting_rot"  # the synthetic rig has no hands
    cfg, jcfg = _net_cfgs(task, side)
    rng = np.random.RandomState(NET_TASKS.index(task))
    x = (rng.randn(N, 64) if task == "img_lifting_rot" else rng.rand(N, *HM, J)).astype(np.float32)
    hand = np.array([0, 1], np.int32) if side else None
    jnet = JLiftingNet(jcfg)
    variables = randomize_variables(_random_variables(
        lambda k: jnet.init(k, x, hand, None, train=False), rng), rng)
    want = jax.jit(lambda v, x, h: jnet.apply(v, x, h, None, train=False))(variables, x, hand)

    net = LiftingNet(cfg, in_features=64, hand_side=side)
    assert load_jax_variables(net, variables) == flatten_variables(variables)
    xt = torch.from_numpy(x if x.ndim == 2 else x.transpose(0, 3, 1, 2).copy())
    got = net.eval()(xt, None if hand is None else torch.from_numpy(hand))
    for name, g, w in zip(("coords", "rotation", "normed", "global"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_pool_floors_its_windows_as_jax_does():
    """At 76 x 84 the pool-8 windows leave rows and columns over: the port
    floors them as flax's VALID `avg_pool` does (what the test above holds
    to JAX), where the reference's AvgPool2d(ceil_mode=True) keeps a partial
    window (ROADMAP C: the pool floor)."""
    cfg, _ = _net_cfgs("lifting_rot")
    x = torch.rand(1, J, *HM)
    assert F.avg_pool2d(x, 8, 8).shape[-2:] == (9, 10)
    assert F.avg_pool2d(x, 8, 8, ceil_mode=True).shape[-2:] == (10, 11)
    assert conv_out_size(cfg) == (2, 2)
    net = LiftingNet(cfg, hand_side=True)
    assert net.poseprior[0].in_features == 128 * 2 * 2 + 2


@pytest.mark.parametrize("task", ["lifting_direct", "lifting_rot"])
def test_liftingnet_matches_reference_golden(task):
    """The reference state dict (rebuilt from the fixture's key manifest)
    loads as it is, strict, with no permutation: the port flattens NCHW."""
    g = np.load(os.path.join(FIXTURES, "lifting_golden.npz"))
    det_tensor = _det_tensor()
    cfg, _ = _net_cfgs(task, hm=(256, 256))
    sd = {}
    for key, shape in zip(g[f"{task}__sd_keys"], g[f"{task}__sd_shapes"]):
        shape = tuple(int(s) for s in str(shape).split("x"))
        sd[str(key)] = torch.from_numpy(np.asarray(det_tensor("lift::" + str(key), shape)))
    net = LiftingNet(cfg, hand_side=True)
    net.load_state_dict(sd, strict=True)
    can, rot, normed, _ = net.eval()(torch.from_numpy(g["heat"]), torch.from_numpy(g["hand_side"]))
    np.testing.assert_allclose(can.detach().numpy(), g[f"{task}__canonical"], rtol=1e-4, atol=1e-5)
    if task == "lifting_rot":
        np.testing.assert_allclose(rot.detach().numpy(), g[f"{task}__rot"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(normed.detach().numpy(), g[f"{task}__normed"], rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------------------- the tasks
TASKS = ["lifting", "lifting_direct", "lifting_rot", "keypoint_lifting_rot",
         "keypoint_lifting_direct", "img_lifting_rot", "multiview_img_lifting_rot"]


def _lifting_targets(rng, n, joints):
    def rotations():
        out = []
        for _ in range(n):
            q, r = np.linalg.qr(rng.randn(3, 3))
            out.append(q * np.sign(np.diag(r)))
        return np.stack(out).astype(np.float32)

    return {"visibility": (rng.rand(n, joints) > 0.2).astype(np.float32),
            "can-points-3d": rng.randn(n, joints, 3).astype(np.float32),
            "normed-points-3d": rng.randn(n, joints, 3).astype(np.float32),
            "rotation": rotations(),
            "scale": (1.0 + rng.rand(n)).astype(np.float32),
            "unit": np.full((n,), 10.0, np.float32)}


def task_case(task, seed=0):
    """(port config, JAX config, host batch) of `task` at a small size."""
    rng = np.random.RandomState(seed)
    if task == "multiview_img_lifting_rot":
        d = {"DATASETS": {"TASK": task}, "LIFTING": {"ENABLED": True},
             "SOLVER": {"IMS_PER_BATCH": N}}
        cfg, jcfg = config_pair(d, tiny_flagship=True)
        np.random.seed(seed)  # the train items draw their reference view from it
        ds = SyntheticMultiview(cfg, is_train=True, n_samples=N, seed=seed)
        batch = collate([ds[i] for i in range(N)])
        batch.update(_lifting_targets(rng, N, cfg.KEYPOINT.NUM_PTS))
        return cfg, jcfg, batch
    body = {"keypoint_lifting_direct": "poseR-18", "img_lifting_rot": "R-18"}.get(task, "poseR-18")
    hm = (16, 16) if task == "keypoint_lifting_direct" else (32, 32)
    d = {"DATASETS": {"TASK": task, "IMAGE_SIZE": (64, 64)},
         "LIFTING": {"ENABLED": True, "FLIP_ON": True, "AVELOSS_KP": task != "lifting_rot"},
         "BACKBONE": {"BODY": body, "DOWNSAMPLE": 4},
         "KEYPOINT": {"NUM_PTS": J, "HEATMAP_SIZE": hm, "SIGMA": 2.0},
         "SOLVER": {"IMS_PER_BATCH": N}, "DATASET_FAMILY": "rhd"}
    cfg, jcfg = config_pair(d)
    batch = {"img": rng.randn(N, 64, 64, 3).astype(np.float32),
             "heatmap": rng.rand(N, *hm, J).astype(np.float32),
             "hand-side": np.array([0, 1], np.int32), **_lifting_targets(rng, N, J)}
    return cfg, jcfg, batch


def _f64(x):
    return x.astype(np.float64) if np.issubdtype(np.asarray(x).dtype, np.floating) else x


def _port_f64(model):
    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


@pytest.mark.parametrize("task", TASKS)
def test_task_loss_and_gradients_match_jax(monkeypatch, task):
    cfg, jcfg, batch = task_case(task)
    if task == "multiview_img_lifting_rot":
        jcfg = jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))
        monkeypatch.setattr(epipolar, "epipolar_sample_locs", jax_sample_locs)
    for module in (jresnet, jepipolar):
        monkeypatch.setattr(module, "compute_dtype", lambda c: jnp.float64)
    jinputs = {k: jnp.asarray(_f64(np.asarray(v))) for k, v in batch.items() if k in MODEL_KEYS}
    jmodel = JModelBuilder(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jinputs, is_train=False),
                                  np.random.RandomState(1))
    variables64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

    def loss_fn(params):
        loss_dict, metric_dict, out = jmodel.apply(
            {"params": params, "batch_stats": variables64.get("batch_stats", {})},
            jinputs, is_train=False)
        return loss_dict["loss"], (loss_dict, metric_dict, out)

    (_, (jloss, jmetrics, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables64["params"])

    model = ModelBuilder(cfg)
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    if task == "keypoint_lifting_rot":  # its backbone is never called: no parameters
        assert "backbone" not in model._modules
    model = _port_f64(model).eval()
    inputs = to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS)
    loss_dict, metric_dict, out = model({k: v.double() if v.is_floating_point() else v
                                         for k, v in inputs.items()})
    loss_dict["loss"].backward()
    assert set(loss_dict) == set(jloss) and set(metric_dict) == set(jmetrics)
    for k in loss_dict:
        np.testing.assert_allclose(loss_dict[k].item(), float(jloss[k]), rtol=1e-5, err_msg=k)
    for k in metric_dict:
        np.testing.assert_allclose(metric_dict[k].item(), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert set(out) == set(jout)
    for k, v in out.items():
        w = np.asarray(jout[k])
        v = v.detach().numpy()
        if k == "heatmap_pred":
            w = w.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)

    stats = variables.get("batch_stats", {})
    want = jax_state_dict(model, to_numpy_tree({"params": jgrads, "batch_stats": stats}))[0]
    grads = {k: p.grad for k, p in model.named_parameters()}
    largest = max(float(want[k].abs().max()) for k in grads)
    for k, g in grads.items():
        w = want[k].double().numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()),
                                                                    1e-3 * largest), err_msg=k)


def test_multiview_img_lifting_rot_stops_the_other_views_gradient():
    """The sibling runs under no-grad, with no OTHER_GRAD check: nothing
    reaches `other_img`, whatever EPIPOLAR.OTHER_GRAD says, while the shared
    trunk and the fusion get their gradients through the reference view."""
    cfg, _, batch = task_case("multiview_img_lifting_rot")
    cfg = cfg.replace(EPIPOLAR=cfg.EPIPOLAR.replace(OTHER_GRAD=("other1", "other2")))
    model = trainer.build_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        model.reference.epipolar_sampler.bn.weight.fill_(0.5)
    inputs = to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS)
    inputs["other_img"] = inputs["other_img"].clone().requires_grad_()
    loss_dict, _, _ = model(inputs)
    loss_dict["loss"].backward()
    assert inputs["other_img"].grad is None
    assert float(model.reference.epipolar_sampler.bn.weight.grad.abs().max()) > 0
    assert float(model.reference.conv1.weight.grad.abs().max()) > 0


@pytest.mark.parametrize("medium,upperbound", [(False, False), (True, False), (False, True)],
                         ids=["mean", "lower_median", "upper_bound"])
def test_multiview_fusion_matches_jax(monkeypatch, medium, upperbound):
    """VIS.MULTIVIEW at eval: the views of one sample as the batch, the
    normed predictions rotated to the global frame and fused, against
    tests/test_lifting_e2e.py's JAX setup (keypoint_lifting_rot, 32 x 32)."""
    states = []

    def keep(*args, **kwargs):
        states.append(create_train_state(*args, **kwargs))
        return states[-1]

    monkeypatch.setattr(test_lifting_e2e, "create_train_state", keep)
    jcfg, inputs, jmetrics, _, _ = _multiview_lifting_setup(
        np.random.RandomState(3), medium=medium, upperbound=upperbound)
    state, = states
    cfg, _ = config_pair({
        "LIFTING": {"ENABLED": True, "MULTIVIEW_MEDIUM": medium,
                    "MULTIVIEW_UPPERBOUND": upperbound},
        "KEYPOINT": {"NUM_PTS": 21, "HEATMAP_SIZE": (32, 32), "SIGMA": 4.0},
        "DATASETS": {"TASK": "keypoint_lifting_rot"}, "VIS": {"MULTIVIEW": True},
        "DATASET_FAMILY": "rhd"})
    model = ModelBuilder(cfg)
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})
    host = {k: np.asarray(v) for k, v in inputs.items()}
    got = model.eval()(to_model_inputs(host, torch.device("cpu"),
                                       MODEL_KEYS + ("points-3d",)))[1]
    assert set(got) == set(jmetrics) and "EPEmean_global" in got
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)


def test_two_seeded_train_steps_are_bit_equal():
    """The dropout masks come from a generator seeded with cfg.SEED on the
    model's device: two builds give the same two steps bit for bit, the
    masks are drawn (a train loss differs from the eval one), and the
    global RNG is left alone."""
    cfg, _, batch = task_case("lifting_rot")
    inputs = to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS)
    runs = []
    for _ in range(2):
        model = trainer.build_model(cfg, torch.device("cpu"))
        step = trainer.make_train_step(cfg, model, trainer.make_optimizer(cfg, model))
        state = torch.get_rng_state()
        losses = [step(inputs)["loss"] for _ in range(2)]
        assert torch.equal(torch.get_rng_state(), state)
        runs.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    with torch.no_grad():
        eval_loss = model.eval()(inputs)[0]["loss"]
    assert not torch.equal(eval_loss, model.train()(inputs)[0]["loss"])


@pytest.mark.parametrize("recipe", ["lifting_rot", "lifting_rot_sgd"])
def test_yaml_exponent_floats_parse_in_the_port(recipe):
    """C12: YAML 1.1 reads `1e-5` as a string.  The port's loader parses it
    as yacs did; the JAX loader keeps the string (its lifting recipes then
    fail in the LR schedule).  Every other key of the tree is JAX's."""
    import dataclasses

    from epipolar_transformers_tpu.config import load_config as jax_load_config
    from epipolar_transformers_tpu_torch.config import load_config

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "lifting", f"{recipe}.yaml")
    got, want = load_config(path), jax_load_config(path)
    assert isinstance(got.SOLVER.BASE_LR, float) and isinstance(want.SOLVER.BASE_LR, str)
    assert got.SOLVER.BASE_LR == float(want.SOLVER.BASE_LR)
    assert dataclasses.asdict(got.replace(SOLVER=want.SOLVER)) == dataclasses.asdict(want)
