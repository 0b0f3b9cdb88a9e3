"""One train step of the port's `ModelBuilder` == the JAX `ModelBuilder`'s,
under the fusion options of this slice, with the JAX weights carried across
by utils/jax_import; and the hourglass's FIND_CORR 'rgb' and WARPEDHEATMAP
against the JAX `HourglassNet`.

Steps (tiny widths, batch 2, f64 on both sides: batch-statistics BN over
few values makes the f32 gradients ill-conditioned, see
tests/test_torch_hourglass.py).  The JAX side computes its convolutions in
f64 (its `compute_dtype` patched) and its attention through the f64 oracle
(ATTENTION_IMPL 'reference'; the matmul path rounds the Gram matrix to its
f32 profiles), the port's through its kernel route's plain twin in f64;
the port's layers take the JAX sample locations
(`torch_configs.jax_sample_locs`).  Cases: R-50 at 64
px under MERGE 'early' and 'both' (layer1 has the deconv's 256 channels
there), the flagship's R-18 with the reprojection loss, and epipolarHG11
with WARPEDHEATMAP (the PRIOR table's gradient is held in
tests/test_torch_epipolar_layer.py).
The sample weights stay f32 (computed by each side's own formula, ~1 ulp
apart), which the BN chain carries to ~1e-5 in the loss: the loss and
its terms at rtol 1e-4; every gradient at rtol 1e-4 with atol 1e-5 x its
max, a gradient below 1e-5 of the largest on both sides
(a bias feeding a batch-statistics BN) counting as the true 0 it is.
Module checks in f32: heatmaps rtol 1e-4 with atol 1e-4 x their max,
corr_pos atol 1e-3 px, the warped heatmaps as the heatmaps.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import epipolar as jepipolar
from epipolar_transformers_tpu.models import resnet as jresnet
from epipolar_transformers_tpu.models.hourglass import HourglassNet as JHourglassNet
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models import ModelBuilder, epipolar
from epipolar_transformers_tpu_torch.models.hourglass import HourglassNet
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_hourglass import _cfgs as hg_cfgs
from test_torch_hourglass import _nchw, _random_variables
from test_torch_resnet import assert_heatmaps_close, flatten_variables, to_numpy_tree
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

BATCH = 2
# 64 px: layer4's maps are 2x2, so its batch-statistics BN sees 8 values
PX64 = {"DATASETS": {"IMAGE_SIZE": (64, 64)}, "KEYPOINT": {"HEATMAP_SIZE": (16, 16)}}
R50 = {"BACKBONE": {"BODY": "epipolarposeR-50"}, **PX64}
STEPS = [
    ("early_r50", dict(R50, EPIPOLAR={"MERGE": "early"}), True),
    ("both_r50", dict(R50, EPIPOLAR={"MERGE": "both"}), True),
    ("reproject", {"EPIPOLAR": {"REPROJECT_LOSS_WEIGHT": 0.5}, **PX64}, True),
    ("warped_hg", {"EPIPOLAR": {"WARPEDHEATMAP": True}}, False),
]


EAGER = ("early_r50", "both_r50")


def _cfgs(d, flagship):
    """(port config, JAX config, the JAX config through the f64 oracle)."""
    d = {**d, "SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": 0.1, "IMS_PER_BATCH": BATCH}}
    cfg, jcfg = (config_pair(d, tiny_flagship=True) if flagship
                 else hg_cfgs("epipolarHG11", **d["EPIPOLAR"]))
    return cfg, jcfg, jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))


def _f64(x):
    return x.astype(np.float64) if np.issubdtype(np.asarray(x).dtype, np.floating) else x


@pytest.mark.parametrize("name,d,flagship", STEPS, ids=[s[0] for s in STEPS])
def test_train_step_matches_jax(monkeypatch, name, d, flagship):
    cfg, _, jcfg = _cfgs(d, flagship)
    for module in (jresnet, jepipolar):
        monkeypatch.setattr(module, "compute_dtype", lambda c: jnp.float64)
    np.random.seed(0)  # the train items draw their reference view from it
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=BATCH, seed=0)
    batch = collate([ds[i] for i in range(BATCH)])
    jinputs = {k: jnp.asarray(_f64(np.asarray(batch[k]))) for k in TRAIN_KEYS}
    jmodel = JModelBuilder(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jinputs, is_train=True),
                                  np.random.RandomState(1))
    variables64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

    def loss_fn(params, batch_stats, inputs):
        (loss_dict, _, _), _ = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                            inputs, is_train=True, mutable=["batch_stats"])
        return loss_dict["loss"], loss_dict

    # R-50 eagerly: its BN sees few values (layer4 at 2x2), and there XLA's
    # jitted CPU f64 program moves single gradients by up to 6% (conv1)
    # against its eager one, which agrees with the port's to 1e-7
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    (jloss, jterms), jgrads = (grad_fn if name in EAGER else jax.jit(grad_fn))(
        variables64["params"], variables64["batch_stats"], jinputs)

    model = ModelBuilder(cfg)
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    model.double().train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    inputs = to_model_inputs(batch, torch.device("cpu"), TRAIN_KEYS)
    monkeypatch.setattr(epipolar, "epipolar_sample_locs", jax_sample_locs)
    loss_dict, _, _ = model({k: v.double() if v.is_floating_point() else v
                             for k, v in inputs.items()})
    loss_dict["loss"].backward()
    assert set(loss_dict) == set(jterms)
    for k, v in loss_dict.items():
        np.testing.assert_allclose(v.item(), float(jterms[k]), rtol=1e-4, err_msg=k)

    want = jax_state_dict(model, to_numpy_tree({"params": jgrads,
                                                "batch_stats": variables["batch_stats"]}))[0]
    grads = {k: p.grad for k, p in model.named_parameters()}
    largest = max(float(want[k].abs().max()) for k in grads)
    zero = []
    for k, g in grads.items():
        w = want[k].double().numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        if max(np.abs(w).max(), np.abs(g).max()) < 1e-5 * largest:
            assert k.endswith(".bias"), k
            zero.append(k)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    assert len(zero) < len(grads) // 2


@pytest.fixture
def hg_inputs(camera_ring):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    other_img = rng.randn(2, 64, 64, 3).astype(np.float32)
    other = [rng.randn(2, 16, 16, 32).astype(np.float32)]
    other_hm = rng.rand(2, 16, 16, 5).astype(np.float32)
    KRT = np.stack([camera_ring["KRT"][0]] * 2).astype(np.float32)
    oKRT = np.stack([camera_ring["KRT"][1]] * 2).astype(np.float32)
    return x, other_img, other, other_hm, KRT, oKRT


@pytest.mark.parametrize("epipolar", [
    dict(FIND_CORR="rgb", OTHER_GRAD=()),
    dict(WARPEDHEATMAP=True),
], ids=["rgb", "warped"])
def test_hourglass_fusion_options_match_jax(hg_inputs, epipolar):
    """FIND_CORR 'rgb' (the images average-pooled by DOWNSAMPLE as queries
    and keys) and WARPEDHEATMAP (the other view's heatmaps warped to the
    best sample) on epipolarHG11, eval mode."""
    x, other_img, other, other_hm, KRT, oKRT = hg_inputs
    cfg, jcfg = hg_cfgs("epipolarHG11", **epipolar)  # f32, the JAX layer's 'auto'
    jargs = dict(other_features=[jnp.asarray(o) for o in other], KRT=jnp.asarray(KRT),
                 other_KRT=jnp.asarray(oKRT), other_img=jnp.asarray(other_img),
                 other_heatmaps=jnp.asarray(other_hm), train=False)
    jmodel = JHourglassNet(jcfg)
    variables = _random_variables(lambda k: jmodel.init(k, jnp.asarray(x), **jargs),
                                  np.random.RandomState(1))
    want = jax.jit(lambda v, x: jmodel.apply(v, x, **jargs))(variables, jnp.asarray(x))
    model = HourglassNet(cfg).eval()
    assert load_jax_variables(model, variables) == flatten_variables(variables)
    with torch.no_grad():
        got = model(_nchw(x), other_features=[_nchw(o) for o in other],
                    KRT=torch.from_numpy(KRT), other_KRT=torch.from_numpy(oKRT),
                    other_img=_nchw(other_img), other_heatmaps=_nchw(other_hm))
    assert_heatmaps_close(got.heatmaps[-1].numpy(),
                          np.asarray(want.heatmaps[-1]).transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got.corr_pos.numpy(), np.asarray(want.corr_pos), rtol=1e-4,
                               atol=1e-3)
    if epipolar.get("WARPEDHEATMAP"):
        warped = np.asarray(want.warped_heatmap).transpose(0, 3, 1, 2)
        assert got.warped_heatmap.shape == warped.shape
        assert_heatmaps_close(got.warped_heatmap.numpy(), warped)
    else:
        assert got.warped_heatmap is None and want.warped_heatmap is None
