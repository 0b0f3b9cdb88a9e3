"""The port's fused-attention wrapper on the CPU (its plain PyTorch version)
== the JAX Pallas kernel `epipolar_attention_pallas_batch`, run in Pallas
interpret mode on the CPU exactly as tests/test_epipolar_pallas.py runs it.

Cases as there: dot with softmax on and off, priors x priormul, prior
similarity, all samples out of range, real geometry.  Tolerance rtol 1e-4 /
atol 1e-5: both sides compute in f32 and differ only in summation order.
The CUDA kernel itself is held to the same plain version on the card
(chip_smoke.py).
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.epipolar_attention import AttentionParams as JParams
from epipolar_transformers_tpu.ops.epipolar_attention_pallas import epipolar_attention_pallas_batch
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

TOL = dict(rtol=1e-4, atol=1e-5)


def _case(rng, B=2, K=8, H=6, W=5, C=4):
    feat = [rng.randn(B, H, W, C).astype(np.float32) for _ in range(3)]
    locs = rng.rand(B, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
    return feat, locs


def _both(feat, locs, kw, prior=None):
    want = epipolar_attention_pallas_batch(
        *[jnp.asarray(f) for f in feat], jnp.asarray(locs), JParams(**kw),
        None if prior is None else jnp.asarray(prior))
    before = attn.LAUNCHES
    got = attn.epipolar_attention_batch(
        *[torch.from_numpy(f) for f in feat], torch.from_numpy(locs), AttentionParams(**kw),
        None if prior is None else torch.from_numpy(prior))
    assert attn.LAUNCHES == before == 0  # the CPU path launches no kernel
    for name, g, w in zip(("out", "corr_pos", "depth"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    return got


@pytest.mark.parametrize("kw", [
    dict(),
    dict(softmax_enabled=False),
    dict(priormul=False, prior=True),
    dict(priormul=True, prior=True),
    dict(similarity="prior", prior=True),
], ids=["dot", "dot_nosoftmax", "prior_add", "prior_mul", "prior_similarity"])
def test_plain_matches_pallas(rng, kw):
    kw = dict(kw)
    has_prior = kw.pop("prior", False)
    feat, locs = _case(rng)
    prior = rng.rand(2, 8, 6, 5).astype(np.float32) * 0.1 if has_prior else None
    _both(feat, locs, dict(attention="avg", softmax_scale=1 / np.sqrt(8), **kw), prior)


def test_plain_all_out_of_range(rng):
    """Lines missing the image: sim == 0 sentinel -> masked -> exact zeros."""
    feat, _ = _case(rng)
    locs = np.full((2, 8, 6, 5, 2), -9.0, np.float32)
    out, _, depth = _both(feat, locs, dict(softmax_scale=1 / np.sqrt(8)))
    assert out.abs().max().item() == 0.0
    np.testing.assert_allclose(depth.numpy(), 1 / 8)


def test_plain_real_geometry(rng, camera_ring):
    from epipolar_transformers_tpu_torch.ops.epipolar_sampling import (
        EpipolarGeometry, epipolar_sample_locs)

    H = W = 16
    geom = EpipolarGeometry(feat_h=H, feat_w=W, sample_size=16, downsample=4,
                            resize=1.0, correct_normalize=True)
    P = torch.from_numpy(camera_ring["KRT"].astype(np.float32))
    locs = epipolar_sample_locs(P[[0, 2]], P[[1, 3]], geom).numpy()
    f1 = rng.randn(2, H, W, 8).astype(np.float32)
    o1 = rng.randn(2, H, W, 8).astype(np.float32)
    _both([f1, o1, o1], locs, dict(softmax_scale=0.25))


def test_bf16_features_follow_jax_dtype_rules(rng):
    """bf16 keys make the Gram matrix bf16 and the output other2's dtype."""
    feat, locs = _case(rng)
    t = [torch.from_numpy(f) for f in feat]
    out, _, depth = attn.epipolar_attention_batch(
        t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(), torch.from_numpy(locs),
        AttentionParams(softmax_scale=1 / np.sqrt(8)))
    ref, _, ref_depth = attn.epipolar_attention_batch(
        *t, torch.from_numpy(locs), AttentionParams(softmax_scale=1 / np.sqrt(8)))
    assert out.dtype == torch.bfloat16 and depth.dtype == torch.float32
    # bf16 rounding of features, Gram and weights: a few 2^-9 steps
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(depth.numpy(), ref_depth.numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kw", [
    dict(attention="max", similarity="dot"),
    dict(attention="avg", similarity="cos"),
    dict(attention="avg", similarity="dot", pooling=True),
], ids=["max", "cos", "pooling"])
def test_wrapper_rejects_uncovered_configs(rng, kw):
    feat, locs = _case(rng)
    params = AttentionParams(**kw)
    assert not attn.supports_fused_attention(params)
    with pytest.raises(ValueError, match="A10"):
        attn.epipolar_attention_batch(*[torch.from_numpy(f) for f in feat],
                                      torch.from_numpy(locs), params)


def test_epipolar_layer_matches_reference_golden():
    """The port's Epipolar layer (no z) against activations saved from the
    reference torch code, with the JAX package's golden-test bounds."""
    from epipolar_transformers_tpu_torch.config import Config, update_from_dict
    from epipolar_transformers_tpu_torch.models.epipolar import Epipolar

    g = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "epipolar_golden.npz"))
    for case, correct in (("avg_dot_correct", True), ("avg_dot_legacy", False)):
        cfg = update_from_dict(Config(), {
            "KEYPOINT": {"HEATMAP_SIZE": (16, 16), "NUM_PTS": 17},
            "BACKBONE": {"DOWNSAMPLE": int(g["downsample"])},
            "DATASETS": {"IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0},
            "EPIPOLAR": {"SAMPLESIZE": int(g["samplesize"]), "ATTENTION": "avg",
                         "SIMILARITY": "dot", "MERGE": "late", "PARAMETERIZED": (),
                         "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": correct}})
        layer = Epipolar(cfg).eval()
        with torch.no_grad():
            out, _, depth, _ = layer(torch.from_numpy(g["feat1"]), torch.from_numpy(g["feat2"]),
                                     torch.from_numpy(g["P1"]), torch.from_numpy(g["P2"]))
        want_out = g[f"{case}__out"]
        np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=0.03, err_msg=case)
        assert np.abs(out.numpy() - want_out).mean() < 3e-3
        np.testing.assert_allclose(depth.numpy(), g[f"{case}__depth"], rtol=0, atol=0.03)
