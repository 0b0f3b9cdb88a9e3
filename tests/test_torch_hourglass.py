"""The port's hourglass family == the JAX package's, with the JAX weights
carried across by utils/jax_import (Meta's dense kernels transposed).

Tiny sizes: NFEATS 32, 64 px, 16x16 heatmaps, K=8, 5 joints.  Weights are
randomized with numpy as in test_torch_resnet.py (the zero-init fusion BN
too, or the `z` branch would be invisible).  Tolerances, f32 on both sides:
`resize_bilinear_align_corners` rtol 1e-6; Meta rtol 1e-5; `Residual` and
`HierarchicalPMS` rtol 1e-4 with atol 1e-4 x their max; heatmaps rtol
1e-4 with atol 1e-4 x their max (test_torch_resnet.py); the multiview
forward's locs, corr_pos (atol 1e-3 px) and depth as test_torch_resnet.py
holds locs and features; the train step as test_torch_train_step.py holds
it (loss rtol 1e-5; each gradient rtol 1e-4, atol 1e-4 x its max; running
statistics rtol 1e-5, atol 1e-5 x their max).

The train step runs in float64 on both sides (the test suite enables x64;
the port's model `.double()` with every convolution and its attention's
plain twin computing in f64; the JAX attention through its f64 oracle,
ATTENTION_IMPL 'reference', as the matmul path rounds the Gram matrix to
its f32 profiles; the port's layer taking the JAX sample locations,
`torch_configs.jax_sample_locs`): in f32 the hourglass's gradients are
ill-conditioned under batch-statistics BN.  Measured at this size, the f32
gradients of JAX and of the port each stray from the f64 ones by up to
3e-1 and 4e-2 of a parameter's max (BN biases whose gradient is a
near-cancellation), and flax's E[x^2] - E[x]^2 batch variance moves the
JAX f32 loss by 1.7e-4.  The port's f32 loss, once held to the f64 one
too, moved with torch's thread count (ROADMAP C7); every comparison is now
f64, and the module runs torch on one thread.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import hourglass as jhourglass
from epipolar_transformers_tpu.models.hourglass import HourglassNet as JHourglassNet
from epipolar_transformers_tpu.models.meta import Meta as JMeta
from epipolar_transformers_tpu.ops.resize import resize_bilinear_align_corners as jresize
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine.tester import EVAL_KEYS, TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models import ModelBuilder, epipolar, hourglass
from epipolar_transformers_tpu_torch.models.hourglass import HourglassNet
from epipolar_transformers_tpu_torch.models.meta import Meta
from epipolar_transformers_tpu_torch.ops.resize import resize_bilinear_align_corners
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_resnet import (assert_heatmaps_close, flatten_variables, randomize_variables,
                               to_numpy_tree)
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

BATCH = 4


def _cfgs(body="epipolarHG1", **epipolar):
    return config_pair({
        "DATASETS": {"TRAIN": ("synthetic_multiview_train",),
                     "TEST": ("synthetic_multiview_val",), "TASK": "multiview_keypoint",
                     "IMAGE_SIZE": (64, 64), "IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0},
        "BACKBONE": {"ENABLED": True, "BODY": body, "PRETRAINED": False, "DOWNSAMPLE": 4},
        "KEYPOINT": {"ENABLED": True, "NUM_PTS": 5, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0,
                     "NFEATS": 32, "LOSS": "joint", "LOSS_PER_JOINT": False},
        "EPIPOLAR": {"SAMPLESIZE": 8, "MERGE": "late", "ATTENTION": "avg", "SIMILARITY": "dot",
                     "PARAMETERIZED": ("z",), "ZRESIDUAL": True, "SHARE_WEIGHTS": True,
                     "PRETRAINED": False, "USE_CORRECT_NORMALIZE": True, **epipolar},
        "SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": 0.1, "IMS_PER_BATCH": BATCH},
    })


def _random_variables(init, rng):
    """Random O(1) variables in the tree `init(key)` builds: its structure
    from `jax.eval_shape` (a trace, no compile), its values from `rng`."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return _randomized(jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes), rng)


def _randomized(variables, rng):
    variables = randomize_variables(to_numpy_tree(variables), rng)

    def walk(node):  # every zero-init fusion BN gets a random scale
        for k, v in node.items():
            if k == "bn" and "norm" in v:
                v["norm"]["scale"] = rng.randn(*v["norm"]["scale"].shape).astype(np.float32)
            elif hasattr(v, "items"):
                walk(v)
    walk(variables["params"])
    return variables


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape,size", [((2, 5, 7, 3), (10, 14)), ((1, 2, 2, 4), (4, 4)),
                                         ((2, 4, 4, 8), (8, 8)), ((1, 3, 3, 2), (3, 3))])
def test_resize_matches_jax(rng, shape, size):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), size)).transpose(0, 3, 1, 2)
    got = resize_bilinear_align_corners(_nchw(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_meta_matches_jax(rng, camera_ring):
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    KRT = jnp.asarray(np.stack([camera_ring["KRT"][0]] * 2).astype(np.float32))
    oKRT = jnp.asarray(np.stack([camera_ring["KRT"][1], camera_ring["KRT"][2]]).astype(np.float32))
    jmeta = JMeta(in_channels=8)
    variables = _random_variables(lambda k: jmeta.init(k, KRT, oKRT, jnp.asarray(x)), rng)
    want = np.asarray(jmeta.apply(variables, KRT, oKRT, jnp.asarray(x))).transpose(0, 3, 1, 2)
    meta = Meta(8)
    assert load_jax_variables(meta, variables) == flatten_variables(variables)
    with torch.no_grad():
        got = meta(torch.tensor(np.asarray(KRT)), torch.tensor(np.asarray(oKRT)),
                   _nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("module", ["Residual", "HierarchicalPMS"])
@pytest.mark.parametrize("num_in,num_out", [(12, 16), (16, 16)], ids=["branch", "identity"])
def test_residual_modules_match_jax(rng, module, num_in, num_out):
    """Both residual modules, with the branch convolution and without, on
    running statistics.  No body builds HierarchicalPMS; this holds it."""
    cfg, jcfg = _cfgs()
    x = rng.randn(2, 8, 8, num_in).astype(np.float32)
    jblock = getattr(jhourglass, module)(jcfg, num_out)
    variables = _random_variables(lambda k: jblock.init(k, jnp.asarray(x), train=False), rng)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False)).transpose(0, 3, 1, 2)
    block = getattr(hourglass, module)(cfg, num_in, num_out).eval()
    assert load_jax_variables(block, variables) == flatten_variables(variables)
    with torch.no_grad():
        got = block(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("body,stacks", [("HG11", 1), ("HG", 3)])
def test_single_view_hourglass_matches_jax(rng, body, stacks):
    cfg, jcfg = _cfgs(body)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmodel = JHourglassNet(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jnp.asarray(x), train=False), rng)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    model = HourglassNet(cfg).eval()
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got.heatmaps) == stacks
    for i, (g, w) in enumerate(zip(got.heatmaps, want.heatmaps)):
        assert_heatmaps_close(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                              err_msg=f"stack {i}")
    np.testing.assert_allclose(got.locs.numpy(), np.asarray(want.locs), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want.scores).max()))


def _batch(cfg, train: bool):
    np.random.seed(0)  # the train items draw their reference view from it
    ds = SyntheticMultiview(cfg, is_train=train, n_samples=BATCH, seed=0)
    if train:
        return collate([ds[i] for i in range(BATCH)])
    return {k: v for k, v in ds[0].items()}  # one view group: its views are the batch


def test_multiview_hourglass_eval_matches_jax(rng):
    """epipolarHG1 through ModelBuilder at eval: the sibling's per-merge-point
    features, the epipolar fusion, the decode; two passes (no trunk fusion)."""
    cfg, jcfg = _cfgs()
    group = _batch(cfg, train=False)
    jinputs = {k: jnp.asarray(np.asarray(group[k], np.float32)) for k in EVAL_KEYS}
    jmodel = JModelBuilder(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jinputs, is_train=False), rng)
    want = {k: np.asarray(v, np.float32) for k, v in jax.jit(
        lambda v, x: jmodel.apply(v, x, is_train=False)[2])(variables, jinputs).items()}
    model = ModelBuilder(cfg).eval()
    assert not model._can_fuse_trunks()
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    with torch.inference_mode():
        got = model(to_model_inputs(group, torch.device("cpu")))
    assert set(got) == set(want) == {"heatmap_pred", "batch_locs", "score_pred", "corr_pos",
                                     "depth"}
    assert_heatmaps_close(got["heatmap_pred"].numpy(), want["heatmap_pred"].transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got["batch_locs"].numpy(), want["batch_locs"], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["corr_pos"].numpy(), want["corr_pos"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(want["depth"]).max()))


@pytest.mark.parametrize("merge,n_points", [("early", 1), ("both", 2), ("none", 1)])
def test_merge_feature_lists_match_jax(rng, camera_ring, merge, n_points):
    """MERGE early/both/none: the per-merge-point `features` (what a sibling
    hands over), the heatmaps and, where it fuses, corr_pos."""
    cfg, jcfg = _cfgs("epipolarHG11", MERGE=merge)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    other = [rng.randn(2, 16, 16, 32).astype(np.float32) for _ in range(n_points)]
    KRT = np.stack([camera_ring["KRT"][0]] * 2).astype(np.float32)
    oKRT = np.stack([camera_ring["KRT"][1]] * 2).astype(np.float32)
    jargs = dict(other_features=[jnp.asarray(o) for o in other], KRT=jnp.asarray(KRT),
                 other_KRT=jnp.asarray(oKRT), train=False)
    jmodel = JHourglassNet(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jnp.asarray(x), **jargs), rng)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, **jargs))(variables, jnp.asarray(x))
    model = HourglassNet(cfg).eval()
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    assert hasattr(model, "epipolar_sampler") == (merge != "none")
    with torch.no_grad():
        got = model(_nchw(x), other_features=[_nchw(o) for o in other],
                    KRT=torch.from_numpy(KRT), other_KRT=torch.from_numpy(oKRT))
    assert len(got.features) == len(want.features) == n_points
    for i, (g, w) in enumerate(zip(got.features, want.features)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"features[{i}]")
    assert_heatmaps_close(got.heatmaps[-1].numpy(),
                          np.asarray(want.heatmaps[-1]).transpose(0, 3, 1, 2))
    assert (got.corr_pos is None) == (want.corr_pos is None) == (merge == "none")
    if merge != "none":
        np.testing.assert_allclose(got.corr_pos.numpy(), np.asarray(want.corr_pos), rtol=1e-4,
                                   atol=1e-3)


@pytest.fixture(scope="module")
def step():
    """One JAX train step (`loss_fn` of the JAX trainer) and one port
    train step, both in f64, on the same weights and batch of the tiny
    epipolarHG1."""
    rng = np.random.RandomState(0)
    cfg, jcfg = _cfgs()
    jcfg = jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))
    batch = _batch(cfg, train=True)
    jinputs = {k: jnp.asarray(np.asarray(batch[k], np.float32)) for k in TRAIN_KEYS}
    jmodel = JModelBuilder(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jinputs, is_train=True), rng)
    variables64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    jinputs = {k: v.astype(jnp.float64) for k, v in jinputs.items()}

    def loss_fn(params, batch_stats, inputs):
        (loss_dict, _, _), mutated = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, inputs, is_train=True,
            mutable=["batch_stats"])
        return loss_dict["loss"], mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables64["params"], variables64["batch_stats"], jinputs)

    inputs = to_model_inputs(batch, torch.device("cpu"), TRAIN_KEYS)
    model = ModelBuilder(cfg)
    load_jax_variables(model, variables)
    model.double().train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epipolar, "epipolar_sample_locs", jax_sample_locs)
        loss_dict, _, _ = model({k: v.double() if v.is_floating_point() else v
                                 for k, v in inputs.items()})
    loss_dict["loss"].backward()

    def as_port(params, batch_stats):
        return jax_state_dict(model, to_numpy_tree({"params": params, "batch_stats": batch_stats}))[0]

    return dict(model=model, loss=loss_dict["loss"].item(), jloss=float(jloss),
                grads={k: p.grad for k, p in model.named_parameters()},
                jgrads=as_port(jgrads, variables["batch_stats"]),
                jstats=as_port(variables["params"], jstats))


def test_train_step_loss_matches_jax(step):
    np.testing.assert_allclose(step["loss"], step["jloss"], rtol=1e-5)


def test_train_step_gradients_match_jax(step):
    """Every gradient; a bias that feeds a batch-statistics BN has a true
    gradient of 0, and both sides give rounding noise below 1e-5 x the
    largest gradient (test_torch_train_step.py's rule for its one such
    bias)."""
    floor = 1e-5 * max(float(g.abs().max()) for g in step["jgrads"].values())
    assert float(step["grads"]["reference.epipolar_sampler.z.weight"].abs().max()) > floor
    zero = []
    for name, got in step["grads"].items():
        want = step["jgrads"][name].numpy()
        if np.abs(want).max() < floor:
            assert name.endswith(".bias") and got.abs().max().item() < floor, name
            zero.append(name)
            continue
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    assert "reference.epipolar_sampler.z.bias" in zero
    assert len(zero) < len(step["grads"]) // 2


def test_train_step_running_statistics_match_jax(step):
    state = step["model"].state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        want = step["jstats"][k].numpy()
        np.testing.assert_allclose(state[k].double().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)
