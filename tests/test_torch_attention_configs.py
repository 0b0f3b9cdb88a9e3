"""The port's plain attention paths for the configs the CUDA kernel does not
cover (ops/epipolar_attention.py, ops/epipolar_attention_pooled.py) == the
JAX package's, on inputs made from a numpy seed, on the CPU.

Forward, f32, rtol 1e-4 and atol 1e-5: the oracle (JAX
`epipolar_attention_batch`) for dot, cos, max, softmax off, prior
similarity, additive priors and priormul, with and without POOLING; the
JAX matmul path (`epipolar_attention_matmul`) for the unpooled ones; the
pooled path (`epipolar_attention_pooled`, keys and values apart or one
tensor); and the streaming path's contract (`epipolar_attention_streaming`:
out, corr_pos, and `best_rank` as the (N, 1, H, W) depth placeholder).
Some queries' samples all lie outside the image.

Gradients against `jax.grad` of the path the JAX package trains through,
rtol 1e-4 with atol 1e-5 x the largest: the matmul path for cos, max and
priors (its cosine floors the sample's squared norm, so an out-of-range
sample gives 0, not NaN), the streaming path for POOLING with dot, and
the pooled path for pooled cos/max on in-range locations (its
`jnp.linalg.norm` NaNs the backward of an all-zero sample).  The loss
reads `out` and `depth`.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops import epipolar_attention as jattn
from epipolar_transformers_tpu.ops.epipolar_attention_matmul import epipolar_attention_matmul
from epipolar_transformers_tpu.ops.epipolar_attention_pooled import \
    epipolar_attention_pooled as jpooled
from epipolar_transformers_tpu.ops.epipolar_attention_streaming import \
    epipolar_attention_streaming
from epipolar_transformers_tpu_torch.ops import epipolar_attention as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention_pooled import (
    epipolar_attention_pooled, supports_pooled_attention)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

N, K, H, W, C = 2, 8, 6, 5, 4
FWD = dict(rtol=1e-4, atol=1e-5)

# (id, AttentionParams fields, prior: None | 'add' | 'mul')
CONFIGS = [
    ("dot", dict(), None),
    ("cos", dict(similarity="cos"), None),
    ("max", dict(attention="max"), None),
    ("softmax_off", dict(softmax_enabled=False), None),
    ("cos_prior_add", dict(similarity="cos"), "add"),
    ("cos_priormul", dict(similarity="cos", priormul=True), "mul"),
    ("dot_prior_add_softmax_off", dict(softmax_enabled=False), "add"),
    ("prior_similarity", dict(similarity="prior"), "add"),
    ("pooled_dot", dict(pooling=True), None),
    ("pooled_cos", dict(pooling=True, similarity="cos"), None),
    ("pooled_max", dict(pooling=True, attention="max"), None),
    ("pooled_prior_add", dict(pooling=True), "add"),
    ("pooled_priormul", dict(pooling=True, priormul=True), "mul"),
]
IDS = [c[0] for c in CONFIGS]


def _case(kw, prior_kind, seed=0, in_range=False):
    rng = np.random.RandomState(seed)
    f1, f2k, f2v = (rng.randn(N, H, W, C).astype(np.float32) for _ in range(3))
    if in_range:
        locs = rng.rand(N, K, H, W, 2).astype(np.float32) * 1.8 - 0.9
    else:
        locs = rng.rand(N, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
        locs[0, :, 1, 2] = -9.0  # a query with every sample out of range
        locs[1, :, 4, 0] = 3.0
    k = K // 2 if kw.get("pooling") else K
    prior = None if prior_kind is None else rng.rand(N, k, H, W).astype(np.float32) * 0.1
    return [f1, f2k, f2v, locs, prior]


def _params(kw):
    return (jattn.AttentionParams(softmax_scale=K ** -0.5, **kw),
            attn.AttentionParams(softmax_scale=K ** -0.5, **kw))


def _vmap(fn, params, prior, **kwargs):
    """A single-item JAX attention function over the batch."""
    if prior is None:
        return jax.vmap(lambda a, b, c, s: fn(a, b, c, s, params, **kwargs))
    return jax.vmap(lambda a, b, c, s, p: fn(a, b, c, s, params, p, **kwargs))


def _jax_args(case):
    return [jnp.asarray(x) for x in case if x is not None]


def _torch_args(case):
    return [None if x is None else torch.from_numpy(x) for x in case]


def _assert_close(got, want, names=("out", "corr_pos", "depth"), **tol):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g.detach().numpy(), w, err_msg=name, **(tol or FWD))


@pytest.mark.parametrize("name,kw,prior_kind", CONFIGS, ids=IDS)
def test_forward_matches_jax_oracle(name, kw, prior_kind):
    case = _case(kw, prior_kind)
    jp, pp = _params(kw)
    want = jattn.epipolar_attention_batch(*_jax_args(case[:4]), jp,
                                          None if case[4] is None else jnp.asarray(case[4]))
    got = attn.epipolar_attention(*_torch_args(case[:4]), pp, _torch_args(case)[4])
    _assert_close(got, want)


@pytest.mark.parametrize("name,kw,prior_kind", [c for c in CONFIGS if "pooled" not in c[0]],
                         ids=[i for i in IDS if "pooled" not in i])
def test_forward_matches_jax_matmul_path(name, kw, prior_kind):
    case = _case(kw, prior_kind)
    jp, pp = _params(kw)
    want = _vmap(epipolar_attention_matmul, jp, case[4])(*_jax_args(case))
    got = attn.epipolar_attention(*_torch_args(case[:4]), pp, _torch_args(case)[4])
    _assert_close(got, want)


@pytest.mark.parametrize("shared_kv", [False, True], ids=["apart", "shared"])
@pytest.mark.parametrize("name,kw,prior_kind", [c for c in CONFIGS if "pooled" in c[0]],
                         ids=[i for i in IDS if "pooled" in i])
def test_pooled_matches_jax_pooled_path(name, kw, prior_kind, shared_kv):
    case = _case(kw, prior_kind)
    if shared_kv:
        case[2] = case[1]
    jp, pp = _params(kw)
    assert supports_pooled_attention(pp)
    want = _vmap(jpooled, jp, case[4], shared_kv=shared_kv)(*_jax_args(case))
    got = epipolar_attention_pooled(*_torch_args(case[:4]), pp, _torch_args(case)[4],
                                    shared_kv=shared_kv)
    _assert_close(got, want)


STREAMING = [c for c in CONFIGS if c[0] in ("dot", "cos", "max", "softmax_off", "cos_priormul",
                                              "pooled_dot", "pooled_max", "pooled_prior_add")]


@pytest.mark.parametrize("name,kw,prior_kind", STREAMING, ids=[c[0] for c in STREAMING])
def test_streaming_contract_matches_jax(name, kw, prior_kind):
    """With nothing reading the stack, `depth` is the streaming path's
    best_rank placeholder (JAX models/epipolar.py:341-372)."""
    case = _case(kw, prior_kind)
    jp, pp = _params(kw)
    out, corr_pos, stats = _vmap(epipolar_attention_streaming, jp, case[4], remat=False)(
        *_jax_args(case))
    got = attn.epipolar_attention(*_torch_args(case[:4]), pp, _torch_args(case)[4],
                                  depth="rank")
    assert got[2].shape == (N, 1, H, W)
    _assert_close(got, (out, corr_pos, np.asarray(stats.best_rank)[:, None]))


def _port_grads(fn, case, seed=1):
    """Gradients of sum(out r) + sum(depth r') to the queries, keys,
    values and the prior."""
    rng = np.random.RandomState(seed)
    leaves = [torch.from_numpy(x).requires_grad_() if i != 3 and x is not None
              else None if x is None else torch.from_numpy(x) for i, x in enumerate(case)]
    out, _, depth = fn(*leaves)
    r = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    loss = (out * r).sum()
    if depth is not None:
        loss = loss + (depth * torch.from_numpy(rng.randn(*depth.shape).astype(np.float32))).sum()
    loss.backward()
    # an input the function does not read (the queries and keys of a prior
    # similarity) gets no gradient: zero, as jax.grad gives it
    return [np.zeros_like(case[i]) if leaves[i].grad is None else leaves[i].grad.numpy()
            for i in (0, 1, 2, 4) if leaves[i] is not None]


def _jax_grads(fn, case, seed=1):
    rng = np.random.RandomState(seed)
    args = _jax_args(case)
    out, _, depth = fn(*args)
    r = jnp.asarray(rng.randn(*out.shape).astype(np.float32))
    rd = None if depth is None else jnp.asarray(rng.randn(*depth.shape).astype(np.float32))

    def loss(*diff):
        a = list(diff[:3]) + [args[3]] + list(diff[3:])
        o, _, d = fn(*a)
        return jnp.sum(o * r) + (0.0 if d is None else jnp.sum(d * rd))

    wrt = args[:3] + args[4:]
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(wrt))))(*wrt)]


def _assert_grads_close(got, want):
    names = ("dfeat1", "dother1", "dother2", "dprior")
    assert len(got) == len(want)
    for g, w, name in zip(got, want, names):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=name)


GRADS = [c for c in CONFIGS if "pooled" not in c[0]]


@pytest.mark.parametrize("name,kw,prior_kind", GRADS, ids=[c[0] for c in GRADS])
def test_grads_match_jax_grad_of_matmul_path(name, kw, prior_kind):
    case = _case(kw, prior_kind)
    jp, pp = _params(kw)
    got = _port_grads(lambda *a: attn.epipolar_attention(*a[:4], pp, a[4]), case)
    want = _jax_grads(_vmap(epipolar_attention_matmul, jp, case[4], remat=False), case)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("name,kw,prior_kind", [c for c in CONFIGS if c[0] in (
    "pooled_dot", "pooled_prior_add")], ids=["pooled_dot", "pooled_prior_add"])
def test_pooled_grads_match_jax_grad_of_streaming_path(name, kw, prior_kind):
    """What the JAX layer trains a pooled dot config through ('auto'); the
    loss reads `out` only, as the streaming path returns no stack."""
    case = _case(kw, prior_kind)
    jp, pp = _params(kw)

    def jfn(*a):
        out, corr, _ = _vmap(epipolar_attention_streaming, jp, case[4], remat=False)(*a)
        return out, corr, None

    def pfn(*a):
        out, corr, _ = epipolar_attention_pooled(*a[:4], pp, a[4])
        return out, corr, None

    _assert_grads_close(_port_grads(pfn, case), _jax_grads(jfn, case))


@pytest.mark.parametrize("name,kw,prior_kind", [c for c in CONFIGS if c[0] in (
    "pooled_cos", "pooled_max", "pooled_priormul")],
    ids=["pooled_cos", "pooled_max", "pooled_priormul"])
def test_pooled_grads_match_jax_grad_of_pooled_path(name, kw, prior_kind):
    case = _case(kw, prior_kind, in_range=True)
    jp, pp = _params(kw)
    got = _port_grads(lambda *a: epipolar_attention_pooled(*a[:4], pp, a[4]), case)
    _assert_grads_close(got, _jax_grads(_vmap(jpooled, jp, case[4]), case))


@pytest.mark.parametrize("kw", [dict(similarity="cos"), dict(attention="max"),
                                dict(similarity="cos", pooling=True)],
                         ids=["cos", "max", "pooled_cos"])
def test_all_out_of_range_gives_finite_zero_grads(kw):
    """Every sample outside the image: out 0 and every gradient exactly 0
    (the floored norm keeps the cosine's backward finite)."""
    case = _case(kw, None)
    case[3] = np.full_like(case[3], -9.0)
    _, pp = _params(kw)
    leaves = [torch.from_numpy(x).requires_grad_() for x in case[:3]]
    out, _, depth = attn.epipolar_attention(*leaves, torch.from_numpy(case[3]), pp)
    assert float(out.detach().abs().max()) == 0.0
    (out.sum() + depth.sum()).backward()
    for t in leaves:
        assert torch.isfinite(t.grad).all() and float(t.grad.abs().max()) == 0.0
