"""The port's training step == the JAX package's, on the tiny flagship
config (`flagship_cfg(tiny=True)`: epipolarposeR-18, 32 px, 8x8 heatmaps,
5 joints, K=4) and one batch of 8 synthetic train items, both in f64.

The JAX side is the `loss_fn` of engine/trainer.py:98-110 (under
`jax.value_and_grad` with mutable batch_stats) in f64: its convolutions'
`compute_dtype` patched to f64 and its attention through the f64 oracle
(ATTENTION_IMPL 'reference'; the XLA matmul path rounds the Gram matrix to
its f32 profiles).  The port's side is `ModelBuilder` in train mode and
`loss.backward()`, `.double()` with every convolution in f64 and its
attention's plain twin in f64, taking the JAX sample locations
(`torch_configs.jax_sample_locs`; the f32 geometries differ by ~5e-5).
Both start from the same randomized weights (as in test_torch_slice.py,
including the zero-init BN's scale, without which the `z` branch gets no
gradient).  In f32 the comparisons moved with torch's thread count
(ROADMAP C7); in f64 they do not, so the module runs torch on one thread.

Compared: the loss (rtol 1e-5); every parameter's gradient (rtol 1e-4,
atol 1e-4 x its max); the BN running statistics after the step (rtol 1e-5:
flax moves the running variance with the biased batch variance, torch with
the unbiased one, 8/7 apart on R-18's 1x1 layer4 maps at batch 8); and the
parameters after one sgd step (rtol 1e-5, atol 1e-4 x lr x max|g|).  The
running statistics take atol 1e-5 x their max, for entries near zero.

The gradient bound is the one test_torch_slice.py holds the forward
heatmaps to.  The sample weights stay f32 on both sides (each side's own
formula, ~1 ulp apart), and batch-statistics BN over 8 values per channel
at layer4 carries that on; a structural error (a missing detach, a wrong
BN or attention gradient) is O(1).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from epipolar_transformers_tpu.engine.solver import make_optimizer as jax_make_optimizer
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu.models import epipolar as jepipolar
from epipolar_transformers_tpu.models import resnet as jresnet
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.tester import TRAIN_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.models import ModelBuilder, epipolar
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_resnet import randomize_variables, to_numpy_tree
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

BATCH = 8
LR = 0.1
# feeds the zero-init BN, which runs on batch statistics and so removes any
# constant shift: its true gradient is 0, and both sides give rounding noise
ZERO_GRAD = "reference.epipolar_sampler.z.bias"


def _cfgs():
    """(port config, JAX config through the f64 oracle): the tiny flagship
    with one sgd step."""
    cfg, jcfg = config_pair({"SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": LR,
                                        "IMS_PER_BATCH": BATCH}}, tiny_flagship=True)
    return cfg, jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))


@pytest.fixture(scope="module")
def step():
    """One JAX train step and one port train step on the same weights and
    batch; returns what the tests compare."""
    cfg, jcfg = _cfgs()
    np.random.seed(0)  # the train items draw their reference view from it
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=BATCH, seed=0)
    batch = collate([ds[i] for i in range(BATCH)])
    jinputs = {k: jnp.asarray(np.asarray(batch[k], np.float64)) for k in TRAIN_KEYS}

    with pytest.MonkeyPatch.context() as mp:
        for module in (jresnet, jepipolar):
            mp.setattr(module, "compute_dtype", lambda c: jnp.float64)
        mp.setattr(epipolar, "epipolar_sample_locs", jax_sample_locs)
        jmodel = JModelBuilder(jcfg)
        variables = jax.jit(lambda k: jmodel.init(k, jinputs, is_train=True))(
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        variables = randomize_variables(to_numpy_tree(variables), rng)
        bn = variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]
        bn["scale"] = rng.randn(*bn["scale"].shape).astype(np.float32)
        variables64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params, batch_stats, inputs):
            (loss_dict, _, _), mutated = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, inputs, is_train=True,
                mutable=["batch_stats"])
            return loss_dict["loss"], mutated["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables64["params"], variables64["batch_stats"], jinputs)
        tx = jax_make_optimizer(jcfg, steps_per_epoch=1)
        updates, _ = tx.update(jgrads, tx.init(variables64["params"]), variables64["params"])
        jparams = optax.apply_updates(variables64["params"], updates)

        model = ModelBuilder(cfg)
        load_jax_variables(model, variables)
        model.double().train()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
        optimizer = make_optimizer(cfg, model)
        inputs = to_model_inputs(batch, torch.device("cpu"), TRAIN_KEYS)
        loss_dict, metric_dict, out = model({k: v.double() if v.is_floating_point() else v
                                             for k, v in inputs.items()})
    loss_dict["loss"].backward()
    loss_dict = {k: v.detach() for k, v in loss_dict.items()}
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    optimizer.step()

    def as_port(params, batch_stats):
        state, _ = jax_state_dict(model, to_numpy_tree(
            {"params": params, "batch_stats": batch_stats}))
        return state

    return dict(
        model=model, loss_dict=loss_dict, metric_dict=metric_dict, out=out, grads=grads,
        jloss=float(jloss),
        jgrads=as_port(jgrads, variables["batch_stats"]),
        jstats=as_port(variables["params"], jstats),
        jparams=as_port(jparams, jstats))


def test_loss_matches_jax(step):
    assert set(step["loss_dict"]) == {"loss"} and step["metric_dict"] == {}
    assert set(step["out"]) == {"heatmap_pred", "corr_pos", "depth"}
    np.testing.assert_allclose(step["loss_dict"]["loss"].item(), step["jloss"], rtol=1e-5)


def _grad_scale(step):
    return max(float(np.abs(g.numpy()).max()) for g in step["jgrads"].values())


def test_every_gradient_matches_jax(step):
    zinit = "reference.epipolar_sampler.z.weight"
    assert float(step["grads"][zinit].abs().max()) > 0  # the z branch is live
    floor = 1e-5 * _grad_scale(step)
    for name, got in step["grads"].items():
        want = step["jgrads"][name].numpy()
        if name == ZERO_GRAD:
            assert np.abs(want).max() < floor and got.abs().max().item() < floor, name
            continue
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)


def test_bn_running_statistics_match_jax(step):
    state = step["model"].state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 40
    for k in keys:
        want = step["jstats"][k].numpy()
        np.testing.assert_allclose(state[k].double().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def test_parameters_after_one_sgd_step_match_jax(step):
    floor = 1e-5 * _grad_scale(step)
    for name, p in step["model"].named_parameters():
        # the step moves a parameter by lr * g: its error is lr times the
        # gradient's (the noise itself for the zero-gradient bias)
        atol = LR * (floor if name == ZERO_GRAD
                     else 1e-4 * float(np.abs(step["jgrads"][name].numpy()).max()))
        np.testing.assert_allclose(p.detach().double().numpy(), step["jparams"][name].numpy(),
                                   rtol=1e-5,
                                   atol=atol, err_msg=name)
