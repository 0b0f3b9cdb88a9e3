"""The additive prior's masked softmax (ROADMAP C8) and the prior's
gradient in the transposed backward (ROADMAP B5), on the CPU.

C8: on a row with no valid slot (every similarity exactly 0) the JAX
package's weights are the constant 1/K whatever the prior, and its
gradient to the prior is 0.  The port's `epipolar_similarity_weights`,
the wrapper's `_weights`, the plain version under autograd, the forward's
tile schedule (`_tiled_forward_core`) and the backward's passes
(`_transposed_backward_core`) are held to JAX `epipolar_similarity_weights`
and `jax.grad` of the matmul path there, with priors of 5000 and -3000.

B5: the prior's gradient of `_transposed_backward_core` in each mode
(additive with softmax on and off, priormul with softmax on and off,
similarity 'prior') == autograd of the plain version == `jax.grad` of the
matmul path, at rtol 1e-4 and atol 1e-5 x the largest (f32, summation
order only).  The inputs hold a query with every sample out of range, and
one whose features are zero (every similarity 0 with samples in range):
there dprior is exactly 0 under the softmax, g / K without it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops import epipolar_attention as jattn
from epipolar_transformers_tpu.ops.epipolar_attention_matmul import epipolar_attention_matmul
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as cuda_attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import (
    AttentionParams, epipolar_similarity_weights)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

B, K, H, W, C = 2, 8, 6, 5, 4
PRIORS = [(0.05, 0.02, 0.07, 0.01), (0.0, 5000.0, -3000.0, 100.0)]


@pytest.mark.parametrize("prior", PRIORS, ids=["small", "large"])
def test_degenerate_row_weights_match_jax(prior):
    """All sims 0 (K=4): 1/K each; a row with valid slots: the softmax over them."""
    sim = np.array([[0.0, 0.0, 0.0, 0.0], [0.0, 0.3, -1.2, 0.0]], np.float32)
    p = np.array([prior, prior], np.float32)
    params = AttentionParams(softmax_scale=0.5)
    want = np.asarray(jattn.epipolar_similarity_weights(
        jnp.asarray(sim.T), jattn.AttentionParams(softmax_scale=0.5), jnp.asarray(p.T))).T
    np.testing.assert_allclose(want[0], 0.25)
    got = epipolar_similarity_weights(torch.from_numpy(sim), params, torch.from_numpy(p), dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    wrapper = cuda_attn._weights(torch.from_numpy(sim)[None], torch.from_numpy(p)[None], params)
    np.testing.assert_allclose(wrapper[0].numpy(), want, rtol=1e-6, atol=1e-7)

    pr = torch.from_numpy(p).requires_grad_()
    w = epipolar_similarity_weights(torch.from_numpy(sim), params, pr, dim=1)
    (w * torch.arange(1.0, 5.0)).sum().backward()
    jgrad = jax.grad(lambda q: jnp.sum(jattn.epipolar_similarity_weights(
        jnp.asarray(sim.T), jattn.AttentionParams(softmax_scale=0.5), q).T
        * jnp.arange(1.0, 5.0)))(jnp.asarray(p.T))
    assert float(pr.grad[0].abs().max()) == 0.0
    np.testing.assert_allclose(pr.grad.numpy(), np.asarray(jgrad).T, rtol=1e-5, atol=1e-6)


def _case(big_prior=False, seed=0):
    """Features, random edge-crossing locations (query 3 of item 0 out of
    range, query 7 of item 1 with zero features) and a prior."""
    rng = np.random.RandomState(seed)
    f1, f2, dout = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(3))
    locs = rng.rand(B, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
    locs[0, :, 0, 3] = -9.0
    locs[1, :, 1, 2] = rng.rand(K, 2).astype(np.float32) * 1.6 - 0.8
    f1[1, 1, 2] = 0.0
    prior = rng.rand(B, K, H, W).astype(np.float32) * 0.1
    if big_prior:
        prior[0, :, 0, 3] = np.where(np.arange(K) % 2, 5000.0, -3000.0)
    return f1, f2, locs, dout, prior


def _jax_matmul(kw, f1, f2, locs, prior):
    params = jattn.AttentionParams(softmax_scale=K ** -0.5, **kw)
    return jax.vmap(lambda a, b, s, p: epipolar_attention_matmul(a, b, b, s, params, p,
                                                                 remat=False))(
        f1, f2, locs, prior)


def test_degenerate_rows_through_every_port_path():
    """Additive prior of 5000 / -3000 on a query with every sample out of
    range: depth 1/K on the plain version and the tile schedule, as on the
    JAX matmul path; the prior's gradient through depth 0 (autograd of the
    plain version, jax.grad) and through out 0 (the transposed backward)."""
    f1, f2, locs, dout, prior = _case(big_prior=True)
    params = AttentionParams(softmax_scale=K ** -0.5)
    t = torch.from_numpy
    jout, _, jdepth = _jax_matmul({}, *(jnp.asarray(x) for x in (f1, f2, locs, prior)))
    np.testing.assert_allclose(np.asarray(jdepth)[0, :, 0, 3], 1.0 / K)

    pr = t(prior).requires_grad_()
    out, _, depth = cuda_attn.epipolar_attention_plain_batch(t(f1), t(f2), t(f2), t(locs),
                                                             params, pr)
    np.testing.assert_allclose(depth.detach().numpy(), np.asarray(jdepth), rtol=1e-4, atol=1e-5)
    r = np.random.RandomState(1).randn(*depth.shape).astype(np.float32)
    (depth * t(r)).sum().backward()

    def jloss(p):
        return jnp.sum(_jax_matmul({}, *(jnp.asarray(x) for x in (f1, f2, locs)), p)[2] * r)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(prior)))
    assert float(pr.grad[0, :, 0, 3].abs().max()) == 0.0 == float(np.abs(jgrad[0, :, 0, 3]).max())
    np.testing.assert_allclose(pr.grad.numpy(), jgrad, rtol=1e-4,
                               atol=1e-5 * float(np.abs(jgrad).max()))

    flat = cuda_attn._flat(t(f1), t(f2), t(f2), t(locs), t(prior))
    _, tiled_depth, _ = cuda_attn._tiled_forward_core(*flat, H, W, params)
    np.testing.assert_allclose(tiled_depth.reshape(B, K, H, W).numpy(), np.asarray(jdepth),
                               rtol=1e-4, atol=1e-5)
    *_, dprior = cuda_attn._transposed_backward_core(*flat, t(dout).reshape(B, H * W, C),
                                                     H, W, params)
    jgrad = np.asarray(jax.grad(lambda p: jnp.sum(_jax_matmul(
        {}, *(jnp.asarray(x) for x in (f1, f2, locs)), p)[0] * dout))(jnp.asarray(prior)))
    dprior = dprior.reshape(B, K, H, W).numpy()
    assert np.abs(dprior[0, :, 0, 3]).max() == 0.0
    np.testing.assert_allclose(dprior, jgrad, rtol=1e-4, atol=1e-5 * float(np.abs(jgrad).max()))


MODES = [
    ("additive", dict()),
    ("additive_softmax_off", dict(softmax_enabled=False)),
    ("priormul", dict(priormul=True)),
    ("priormul_softmax_off", dict(priormul=True, softmax_enabled=False)),
    ("prior_similarity", dict(similarity="prior")),
]


@pytest.mark.parametrize("reference", ["autograd_plain", "jax_grad_matmul"])
@pytest.mark.parametrize("name,kw", MODES, ids=[m[0] for m in MODES])
def test_transposed_backward_prior_gradient(name, kw, reference):
    f1, f2, locs, dout, prior = _case()
    t = torch.from_numpy
    params = AttentionParams(softmax_scale=K ** -0.5, **kw)
    d1, dkv_k, dkv_v, dprior = cuda_attn.epipolar_attention_backward_plain(
        t(f1), t(f2), t(f2), t(locs), params, t(dout), t(prior))
    got = [d1.numpy(), (dkv_k + dkv_v).numpy(), dprior.numpy()]
    if reference == "autograd_plain":
        leaves = [t(x).requires_grad_() for x in (f1, f2, prior)]
        out = cuda_attn.epipolar_attention_plain_batch(leaves[0], leaves[1], leaves[1], t(locs),
                                                       params, leaves[2])[0]
        (out * t(dout)).sum().backward()
        want = [np.zeros_like(x) if leaf.grad is None else leaf.grad.numpy()
                for x, leaf in zip((f1, f2, prior), leaves)]
    else:
        def loss(a, b, p):
            return jnp.sum(_jax_matmul(kw, a, b, jnp.asarray(locs), p)[0] * dout)

        want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (f1, f2, prior)))]
    for g, w, which in zip(got, want, ("dfeat1", "dother", "dprior")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=which)

    # the dead rows (every sim 0): dprior 0 under the additive softmax and
    # wherever the prior is unused; g / K without the softmax, which is not
    # 0 where the samples lie in range (the zero query)
    dead = dprior.numpy()[[0, 1], :, [0, 1], [3, 2]]
    if kw in (dict(), dict(priormul=True, softmax_enabled=False)):
        assert np.abs(dead).max() == 0.0, dead
    if kw == dict(softmax_enabled=False):
        assert np.abs(dead[1]).max() > 0.0


def test_prior_similarity_gradient_is_g():
    """Under similarity 'prior' the weights are the prior: dprior = g, the
    values' profile of dout."""
    f1, f2, locs, dout, prior = _case()
    t = torch.from_numpy
    *_, dprior = cuda_attn.epipolar_attention_backward_plain(
        t(f1), t(f2), t(f2), t(locs), AttentionParams(similarity="prior"), t(dout), t(prior))
    pr = t(prior).requires_grad_()
    out = cuda_attn.epipolar_attention_plain_batch(t(f1), t(f2), t(f2), t(locs),
                                                   AttentionParams(similarity="prior"), pr)[0]
    (out * t(dout)).sum().backward()
    np.testing.assert_allclose(dprior.numpy(), pr.grad.numpy(), rtol=1e-5, atol=1e-6)
