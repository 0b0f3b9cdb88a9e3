"""Gradients of the port's epipolar attention on the CPU (its plain PyTorch
version under autograd) == `jax.grad` of the JAX package's XLA matmul path
(`epipolar_attention_matmul`, the path the JAX package trains through), and
the port's Epipolar layer in training mode == the reference's golden
gradients (tests/fixtures/epipolar_grad_golden.npz).

Cases against jax.grad: OTHER_GRAD on (keys and values are the same
tensor, so their gradients add), keys and values detached, softmax off and
an additive prior.  Tolerance rtol 1e-4 with atol 1e-5 x max|want|: both
sides compute in f32 and differ in summation order only.  The golden case
keeps the bounds of the JAX package's own golden test
(test_golden_parity.py:222-229: the two line-geometry f32 paths agree to
~0.05 feature px).  The CUDA backward kernel is held to this same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.epipolar_attention import AttentionParams as JParams
from epipolar_transformers_tpu.ops.epipolar_attention_matmul import epipolar_attention_matmul
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _case(rng, B=2, K=8, H=6, W=5, C=4):
    feat1, feat2 = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(2))
    locs = rng.rand(B, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
    r = rng.randn(B, H, W, C).astype(np.float32)
    return feat1, feat2, locs, r


def _jax_grads(feat1, feat2, locs, r, kw, prior, other_grad):
    params = JParams(**kw)

    def loss(f1, f2):
        o = f2 if other_grad else jax.lax.stop_gradient(f2)
        run = jax.vmap(lambda q, k, v, s, p: epipolar_attention_matmul(q, k, v, s, params, p)[0])
        return jnp.sum(run(f1, o, o, jnp.asarray(locs), prior) * jnp.asarray(r))

    d1, d2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feat1), jnp.asarray(feat2))
    return np.asarray(d1, np.float32), np.asarray(d2, np.float32)


def _port_grads(feat1, feat2, locs, r, kw, prior, other_grad):
    f1 = torch.from_numpy(feat1).requires_grad_()
    f2 = torch.from_numpy(feat2).requires_grad_()
    o = f2 if other_grad else f2.detach()
    out, _, _ = attn.epipolar_attention_batch(
        f1, o, o, torch.from_numpy(locs), AttentionParams(**kw),
        None if prior is None else torch.from_numpy(prior))
    (out * torch.from_numpy(r)).sum().backward()
    return f1.grad.numpy(), None if f2.grad is None else f2.grad.numpy()


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("kw,use_prior,other_grad", [
    (dict(), False, True),
    (dict(), False, False),
    (dict(softmax_enabled=False), False, True),
    (dict(), True, True),
], ids=["other_grad", "detached", "softmax_off", "prior_add"])
def test_plain_grads_match_jax_grad_of_matmul_path(rng, kw, use_prior, other_grad):
    feat1, feat2, locs, r = _case(rng)
    kw = dict(softmax_scale=1 / np.sqrt(8), **kw)
    prior = rng.rand(2, 8, 6, 5).astype(np.float32) * 0.1 if use_prior else None
    want1, want2 = _jax_grads(feat1, feat2, locs, r, kw,
                              None if prior is None else jnp.asarray(prior), other_grad)
    before = attn.BACKWARD_LAUNCHES
    got1, got2 = _port_grads(feat1, feat2, locs, r, kw, prior, other_grad)
    assert attn.BACKWARD_LAUNCHES == before  # the CPU path launches no kernel
    _close(got1, want1, "dfeat1")
    if other_grad:
        _close(got2, want2, "dfeat2")
    else:
        assert got2 is None and np.abs(want2).max() == 0.0


def test_all_out_of_range_gives_exactly_zero_grads(rng):
    """Lines that miss the image: sim == 0 is masked to a constant, so no
    gradient reaches any feature."""
    feat1, feat2, locs, r = _case(rng)
    got1, got2 = _port_grads(feat1, feat2, np.full_like(locs, -9.0), r,
                             dict(softmax_scale=1 / np.sqrt(8)), None, True)
    assert np.abs(got1).max() == 0.0 and np.abs(got2).max() == 0.0


@pytest.mark.parametrize("case,other_grad", [
    ("avg_dot_correct", ("other1", "other2")),
    ("avg_dot_detached", ()),
])
def test_epipolar_layer_grads_match_reference_golden(case, other_grad):
    """The port's Epipolar layer (no z) in training mode: the gradient of
    sum(out * w) against torch autograd through the reference layer."""
    from epipolar_transformers_tpu_torch.config import Config, update_from_dict
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar

    g = np.load(os.path.join(FIXTURES, "epipolar_grad_golden.npz"))
    gf = np.load(os.path.join(FIXTURES, "epipolar_golden.npz"))
    cfg = update_from_dict(Config(), {
        "KEYPOINT": {"HEATMAP_SIZE": (16, 16), "NUM_PTS": 17},
        "BACKBONE": {"DOWNSAMPLE": int(gf["downsample"])},
        "DATASETS": {"IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0},
        "EPIPOLAR": {"SAMPLESIZE": int(gf["samplesize"]), "ATTENTION": "avg",
                     "SIMILARITY": "dot", "MERGE": "late", "PARAMETERIZED": (),
                     "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": True,
                     "OTHER_GRAD": other_grad}})
    layer = Epipolar(cfg).train()
    f1 = torch.from_numpy(gf["feat1"]).requires_grad_()
    f2 = torch.from_numpy(gf["feat2"]).requires_grad_()
    out, _, _, _ = layer(f1, f2, torch.from_numpy(gf["P1"]), torch.from_numpy(gf["P2"]))
    (out * torch.from_numpy(g["w"])).sum().backward()
    for name, got in (("dfeat1", f1.grad), ("dfeat2", f2.grad)):
        want = g[f"{case}__{name}"]
        got = np.zeros_like(want) if got is None else got.numpy()
        if np.abs(want).max() == 0.0:
            assert np.abs(got).max() == 0.0, f"{name} must be exactly zero (detached)"
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=0.12, err_msg=name)
