"""The transposed backward in plain PyTorch (`epipolar_attention_backward_plain`:
the CUDA backward's three passes, the key/value gradients summed per key row
over stably sorted entries instead of scattered) == autograd of the plain
version (`_plain_core`) and == `jax.grad` of the JAX package's XLA matmul
path, on the CPU in f32.

Cases: the synthetic rig's real epipolar lines (tiny flagship: 8x8, K=4),
random locations that cross the image edges, all samples out of range
(exactly zero), an additive prior, priormul, prior similarity, softmax off,
and keys and values detached (only the query gradient is compared).  Keys
and values are one tensor otherwise (OTHER_GRAD), so their gradients add.
Tolerance rtol 1e-4 with atol 1e-5 x each gradient's max: all sides compute
in f32 and differ in summation order only.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.epipolar_attention import AttentionParams as JParams
from epipolar_transformers_tpu.ops.epipolar_attention_matmul import epipolar_attention_matmul
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams
from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs

C = 8
# (name, locations, AttentionParams fields, prior, keys/values get gradients)
CASES = [
    ("rig", "rig", dict(), False, True),
    ("edge_crossing", "random", dict(), False, True),
    ("out_of_range", "out", dict(), False, True),
    ("prior_add", "random", dict(), True, True),
    ("priormul", "random", dict(priormul=True), True, True),
    ("prior_similarity", "random", dict(similarity="prior"), True, True),
    ("softmax_off", "random", dict(softmax_enabled=False), False, True),
    ("detached", "rig", dict(), False, False),
]


def _rig_locs():
    """(4, K, 8, 8, 2) locations of the tiny flagship rig's view pairs."""
    cfg = flagship_cfg(tiny=True)
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = list(range(ds.n_views))
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]], dtype=torch.float32)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry).numpy()


def _case(kind, use_prior):
    rng = np.random.RandomState(0)
    locs = _rig_locs()
    B, K, H, W, _ = locs.shape
    if kind == "random":
        locs = rng.rand(B, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
    elif kind == "out":
        locs = np.full_like(locs, -9.0)
    feat1, feat2, dout = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(3))
    prior = rng.rand(B, K, H, W).astype(np.float32) * 0.1 if use_prior else None
    return feat1, feat2, locs, dout, prior


def _gather_grads(feat1, feat2, locs, dout, kw, prior):
    """dfeat1 and the keys' + values' gradient of the transposed backward."""
    t = torch.from_numpy
    f2 = t(feat2)
    d1, dk, dv = attn.epipolar_attention_backward_plain(
        t(feat1), f2, f2, t(locs), AttentionParams(**kw), t(dout),
        None if prior is None else t(prior))
    return d1.numpy(), (dk + dv).numpy()


def _autograd_grads(feat1, feat2, locs, dout, kw, prior, other_grad):
    f1 = torch.from_numpy(feat1).requires_grad_()
    f2 = torch.from_numpy(feat2).requires_grad_(other_grad)
    out = attn.epipolar_attention_plain_batch(
        f1, f2, f2, torch.from_numpy(locs), AttentionParams(**kw),
        None if prior is None else torch.from_numpy(prior))[0]
    (out * torch.from_numpy(dout)).sum().backward()
    return tuple(np.zeros_like(feat1) if g is None else g.numpy() for g in (f1.grad, f2.grad))


def _jax_grads(feat1, feat2, locs, dout, kw, prior, other_grad):
    params = JParams(**kw)

    def loss(f1, f2):
        f2 = f2 if other_grad else jax.lax.stop_gradient(f2)
        run = jax.vmap(lambda q, k, v, s, p: epipolar_attention_matmul(q, k, v, s, params, p)[0])
        return jnp.sum(run(f1, f2, f2, jnp.asarray(locs),
                           None if prior is None else jnp.asarray(prior)) * jnp.asarray(dout))

    return tuple(np.asarray(g, np.float32)
                 for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(feat1), jnp.asarray(feat2)))


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("reference", ["autograd_plain", "jax_grad_matmul"])
@pytest.mark.parametrize("name,locs,kw,use_prior,other_grad", CASES, ids=[c[0] for c in CASES])
def test_transposed_backward_matches(reference, name, locs, kw, use_prior, other_grad):
    feat1, feat2, locs, dout, prior = _case(locs, use_prior)
    kw = dict(softmax_scale=1 / np.sqrt(locs.shape[1]), **kw)
    ref = _autograd_grads if reference == "autograd_plain" else _jax_grads
    want = ref(feat1, feat2, locs, dout, kw, prior, other_grad)
    got = _gather_grads(feat1, feat2, locs, dout, kw, prior)
    _close(got[0], want[0], "dfeat1")
    if other_grad:
        _close(got[1], want[1], "dkeys + dvalues")
    else:  # the query gradient does not depend on whether keys/values get one
        assert np.abs(want[1]).max() == 0.0
    if name == "out_of_range":
        assert np.abs(got[0]).max() == 0.0 and np.abs(got[1]).max() == 0.0
    elif name != "prior_similarity":
        assert np.abs(got[0]).max() > 0.0 and np.abs(got[1]).max() > 0.0

