"""The port's `Epipolar` layer == the flax module, with the JAX weights
carried across by utils/jax_import (the layer wrapped as `epipolar_sampler`
on both sides), on the CPU in f32.  The port's layer takes the JAX layer's
sample locations (`torch_configs.jax_sample_locs`): the two f32 geometries
differ by up to ~5e-5 on the rig's lines, which a sharp softmax turns into
~1e-4 in the fused output.

Configs: theta/phi/g with BOTTLENECK 2 and POOLING (the param recipe's
layer) under ATTENTION_IMPL 'auto' (the streaming contract: depth is the
(N, 1, H, W) best-rank placeholder), 'pooled' and 'reference'; the learned
PRIOR table, additive, priormul and as the similarity, with a self pair and
an out-of-range camera id reading the zero prior, and the table's gradient
against `jax.grad`; cos and max attention; FIND_CORR 'rgb'.  Forward rtol
1e-4 and atol 1e-5 x the largest (corr_pos atol 1e-3 px); gradients rtol
1e-4 with atol 1e-5 x the largest.  Then ATTENTION_IMPL: the port raises
exactly where the JAX layer raises.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch import nn

from epipolar_transformers_tpu.models.epipolar import Epipolar as JEpipolar
from epipolar_transformers_tpu_torch.models import epipolar
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_resnet import randomize_variables, to_numpy_tree
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

N, C, HM = 4, 32, 8
CAMERAS = (0, 1, 2, 3)


def _cfgs(train=False, **epipolar):
    d = {
        "DATASETS": {"TRAIN": ("synthetic_multiview_train",), "TEST": ("synthetic_multiview_val",),
                     "IMAGE_SIZE": (32, 32), "IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0,
                     "CAMERAS": CAMERAS},
        "BACKBONE": {"DOWNSAMPLE": 4},
        "KEYPOINT": {"NFEATS": C, "HEATMAP_SIZE": (HM, HM), "NUM_PTS": 5},
        "EPIPOLAR": {"SAMPLESIZE": 8, "ATTENTION": "avg", "SIMILARITY": "dot", "MERGE": "late",
                     "PARAMETERIZED": ("z",), "ZRESIDUAL": True, "USE_CORRECT_NORMALIZE": True,
                     **epipolar},
    }
    return config_pair(d)


def _inputs(cfg, seed=0):
    """Features, the rig's view pairs, camera ids (a self pair and an id
    outside the table among them) and downsampled images."""
    rng = np.random.RandomState(seed)
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [0, 1, 2, 3]
    others = [ds.nearest[v] for v in views]
    cams = np.array(views, np.int32)
    other_cams = np.array([others[0], 1, others[2], 9], np.int32)  # (1, 1) self, 9 unlisted
    feats = [rng.randn(N, HM, HM, C).astype(np.float32) for _ in range(2)]
    refs = [rng.rand(N, HM, HM, 3).astype(np.float32) for _ in range(2)]
    return dict(feat1=feats[0], feat2=feats[1],
                P1=ds.rig["KRT"][views].astype(np.float32),
                P2=ds.rig["KRT"][others].astype(np.float32),
                camera=cams, other_camera=other_cams, ref1=refs[0], ref2=refs[1])


def _jax_call(jcfg, x, train):
    args = (jnp.asarray(x["feat1"]), jnp.asarray(x["feat2"]), jnp.asarray(x["P1"]),
            jnp.asarray(x["P2"]))
    kw = dict(camera=jnp.asarray(x["camera"]), other_camera=jnp.asarray(x["other_camera"]),
              ref1=jnp.asarray(x["ref1"]), ref2=jnp.asarray(x["ref2"]), train=train)
    return JEpipolar(jcfg), args, kw


def _variables(jcfg, x, rng, train):
    module, args, kw = _jax_call(jcfg, x, train)
    variables = to_numpy_tree(module.init(jax.random.PRNGKey(0), *args, **kw))
    table = variables["params"].get("prior")
    variables = randomize_variables(variables, rng)
    bn = variables["params"].get("bn")
    if bn is not None:  # the zero-init BN, made visible
        bn["norm"]["scale"] = rng.randn(*bn["norm"]["scale"].shape).astype(np.float32)
    if table is not None:
        variables["params"]["prior"] = rng.randn(*table.shape).astype(np.float32)
    return variables


def _wrapped(variables):
    """The flax tree under `epipolar_sampler`, as a backbone holds it."""
    return {coll: {"epipolar_sampler": tree} for coll, tree in variables.items() if tree}


def _port(cfg, variables, train):
    holder = nn.Module()
    holder.epipolar_sampler = Epipolar(cfg)
    load_jax_variables(holder, _wrapped(variables))
    return holder.epipolar_sampler.train(train)


def _port_call(layer, x, grad=False):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    feats = [t[k].permute(0, 3, 1, 2).contiguous().requires_grad_(grad) for k in ("feat1", "feat2")]
    refs = [t[k].permute(0, 3, 1, 2).contiguous() for k in ("ref1", "ref2")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epipolar, "epipolar_sample_locs", jax_sample_locs)
        out = layer(feats[0], feats[1], t["P1"], t["P2"], t["camera"], t["other_camera"], *refs)
    return out, feats


def _assert_forward(got, want):
    fused, corr_pos, depth, locs = got
    w_fused, w_corr, w_depth, w_locs = (np.asarray(v) for v in want)
    np.testing.assert_allclose(fused.detach().permute(0, 2, 3, 1).numpy(), w_fused, rtol=1e-4,
                               atol=1e-5 * float(np.abs(w_fused).max()), err_msg="fused")
    np.testing.assert_allclose(corr_pos.numpy(), w_corr, rtol=1e-4, atol=1e-3, err_msg="corr_pos")
    assert depth.shape == w_depth.shape, (depth.shape, w_depth.shape)
    np.testing.assert_allclose(depth.detach().numpy(), w_depth, rtol=1e-4,
                               atol=1e-5 * float(np.abs(w_depth).max()), err_msg="depth")
    np.testing.assert_allclose(locs.numpy(), w_locs, rtol=1e-5, atol=1e-5, err_msg="locs")


PARAM = dict(PARAMETERIZED=("z", "theta", "phi", "g"), BOTTLENECK=2, POOLING=True,
             ZRESIDUAL=False)
LAYERS = [
    ("param_auto", dict(PARAM), "streaming", (N, 1, HM, HM)),
    ("param_pooled", dict(PARAM, ATTENTION_IMPL="pooled"), "pooled", (N, 4, HM, HM)),
    ("param_reference", dict(PARAM, ATTENTION_IMPL="reference"), "plain", (N, 4, HM, HM)),
    ("param_prior", dict(PARAM, PRIOR=True), "streaming", (N, 1, HM, HM)),
    ("prior_additive", dict(PRIOR=True), "kernel", (N, 8, HM, HM)),
    ("priormul", dict(PRIOR=True, PRIORMUL=True), "kernel", (N, 8, HM, HM)),
    ("prior_similarity", dict(PRIOR=True, SIMILARITY="prior"), "kernel", (N, 8, HM, HM)),
    ("cos", dict(SIMILARITY="cos"), "plain", (N, 8, HM, HM)),
    ("max_prior", dict(ATTENTION="max", PRIOR=True), "plain", (N, 8, HM, HM)),
    ("theta_g", dict(PARAMETERIZED=("z", "theta", "g")), "kernel", (N, 8, HM, HM)),
    ("rgb", dict(FIND_CORR="rgb", OTHER_GRAD=(), PARAMETERIZED=("z", "theta", "g")), "plain",
     (N, 8, HM, HM)),
]


@pytest.mark.parametrize("name,epipolar,route,depth_shape", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_forward_matches_flax(name, epipolar, route, depth_shape):
    cfg, jcfg = _cfgs(**epipolar)
    x = _inputs(cfg)
    variables = _variables(jcfg, x, np.random.RandomState(1), train=False)
    module, args, kw = _jax_call(jcfg, x, train=False)
    want = module.apply(variables, *args, **kw)
    layer = _port(cfg, variables, train=False)
    assert layer.route == route
    with torch.no_grad():
        got, _ = _port_call(layer, x)
    assert got[2].shape == depth_shape
    _assert_forward(got, want)


@pytest.mark.parametrize("name,epipolar", [
    ("prior_additive", dict(PRIOR=True)),
    ("priormul", dict(PRIOR=True, PRIORMUL=True)),
    ("prior_similarity", dict(PRIOR=True, SIMILARITY="prior")),
    ("param_prior", dict(PARAM, PRIOR=True)),
    ("cos", dict(SIMILARITY="cos", OTHER_GRAD=("other1", "other2"))),
], ids=["prior_additive", "priormul", "prior_similarity", "param_prior", "cos"])
def test_layer_train_gradients_match_jax(name, epipolar):
    """One train-mode forward (batch-statistics BN) and sum(fused r): the
    gradients of every parameter (the prior table's too) and of the
    features, against jax.grad of the flax module."""
    cfg, jcfg = _cfgs(**epipolar)
    x = _inputs(cfg)
    variables = _variables(jcfg, x, np.random.RandomState(2), train=True)
    module, args, kw = _jax_call(jcfg, x, train=True)
    r = np.random.RandomState(3).randn(N, HM, HM, C).astype(np.float32)

    def loss(params, f1, f2):
        out, _ = module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              f1, f2, *args[2:], **kw, mutable=["batch_stats"])
        return jnp.sum(out[0] * r)

    jgrads, jf1, jf2 = jax.grad(loss, argnums=(0, 1, 2))(variables["params"], *args[:2])
    layer = _port(cfg, variables, train=True)
    (fused, *_), feats = _port_call(layer, x, grad=True)
    (fused * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()

    holder = nn.Module()
    holder.epipolar_sampler = layer
    want = jax_state_dict(holder, to_numpy_tree(_wrapped(
        {"params": jgrads, "batch_stats": variables["batch_stats"]})))[0]
    grads = {"epipolar_sampler." + k: p.grad for k, p in layer.named_parameters()}
    assert "epipolar_sampler.prior" in grads or "PRIOR" not in epipolar
    largest = max(float(want[k].abs().max()) for k in grads)
    for k, g in grads.items():
        w = want[k].numpy()
        if np.abs(w).max() < 1e-5 * largest:
            # a true 0, rounding noise on both sides (test_torch_train_step.py's
            # rule): z's bias feeds a batch-statistics BN, and phi's adds
            # one constant to every valid logit of a softmax
            assert k.endswith(("z.bias", "phi.bias")), k
            assert float(g.abs().max()) < 1e-5 * largest, k
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=k)
    for t, w in ((feats[0], jf1), (feats[1], jf2)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()  # unread: 0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


def test_prior_reads_zero_for_unlisted_pairs():
    """The self pair (1, 1), the id 9 (past the -1 guard) and -1 (wrapped
    onto the guard) read 0; a listed pair reads its own slot, and -7 wraps
    and clamps to 0 as JAX indexes; the gradient of a slot sums its items
    in item order, bit-equal run to run."""
    cfg, _ = _cfgs(PRIOR=True)
    layer = Epipolar(cfg)
    table = torch.arange(float(layer.prior.numel())).reshape(layer.prior.shape)
    with torch.no_grad():
        layer.prior.copy_(table)
    cams = torch.tensor([0, 1, 2, 3, -1, 2])
    others = torch.tensor([1, 1, 9, 2, 0, -7])
    got = layer.pair_prior(cams, others)
    pairs = [(i, j) for i in CAMERAS for j in CAMERAS if i != j]
    assert torch.equal(got[0], table[pairs.index((0, 1))])
    assert torch.equal(got[3], table[pairs.index((3, 2))])
    assert torch.equal(got[5], table[pairs.index((2, 0))])
    for n in (1, 2, 4):
        assert float(got[n].detach().abs().max()) == 0.0, n
    r = torch.randn(got.shape, generator=torch.Generator().manual_seed(0))
    grads = []
    for _ in range(2):
        layer.prior.grad = None
        prior = layer.pair_prior(torch.tensor([0, 0, 3]), torch.tensor([1, 1, 2]))
        (prior * r[:3]).sum().backward()
        grads.append(layer.prior.grad.clone())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0][pairs.index((0, 1))], r[0] + r[1], rtol=0, atol=0)


IMPL_CONFIGS = [
    ("dot", dict()),
    ("cos", dict(SIMILARITY="cos")),
    ("max", dict(ATTENTION="max")),
    ("pooled", dict(POOLING=True)),
    ("prior_similarity", dict(PRIOR=True, SIMILARITY="prior")),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("impl", ["auto", "pallas", "matmul", "pooled", "streaming",
                                  "reference", "bogus"])
def test_attention_impl_raises_where_jax_raises(impl, train):
    for name, epipolar in IMPL_CONFIGS:
        cfg, jcfg = _cfgs(ATTENTION_IMPL=impl, **epipolar)
        x = _inputs(cfg)
        module, args, kw = _jax_call(jcfg, x, train=train)
        try:
            jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
            jax_raised = False
        except ValueError:
            jax_raised = True
        try:
            layer = Epipolar(cfg).train(train)
            with torch.no_grad():
                _port_call(layer, x)
            port_raised = False
        except ValueError:
            port_raised = True
        assert port_raised == jax_raised, (impl, name, train, jax_raised)
