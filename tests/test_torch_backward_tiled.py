"""The backward kernel's tile schedule in plain PyTorch (`_tiled_backward_core`:
the forward's line grouping and tiles, per tile the local products G_t and
Gd_t, w and ds from their live-corner slots, D_t and N_t, dfeat1 = D_t K_U
and the key/value partials D_t^T F1_t and N_t^T dOut_t, summed per key row
in tile order, then the entries of the queries the tile path left through
the transposed per-query passes) == autograd of the plain version
(`_plain_core`) and == `jax.grad` of the JAX package's XLA matmul path, on
the CPU in f32.

Cases: the synthetic rig's real epipolar lines (tiny flagship: 8x8, K=4,
tiles of 8 queries), the same with the union cap at the median union so
that one call runs both paths, random locations that cross the image edges
(no lines: every tile on the per-query path), all samples out of range
(exactly zero), an additive prior, priormul, prior similarity and softmax
off (with the prior's gradient where there is a prior), keys and values
detached (only the query gradient), and keys = values one tensor (their
gradients add).  Keys and values are separate tensors otherwise.  Tolerance
rtol 1e-4 with atol 1e-5 x each gradient's max, as
tests/test_torch_backward_gather.py: all sides compute in f32 and differ in
summation order only.

At the rig's 96x96 locations (the 384 px recipes' heatmaps, B=8, K=64) the
backward's cap holds at least 95% of the tiles (all of them when this test
was written: max union 297 of 320), where the forward's cap of 256 holds
220 of 1152.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.epipolar_attention import AttentionParams as JParams
from epipolar_transformers_tpu.ops.epipolar_attention_matmul import epipolar_attention_matmul
from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams
from epipolar_transformers_tpu_torch.ops.epipolar_sampling import epipolar_sample_locs
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

C = 8
TILE_Q = 8  # 8 tiles an item at 8x8
# (name, locations, AttentionParams fields, prior, keys/values: "apart",
#  "same" tensor or "detached", union cap: None (the kernel's) or "median")
CASES = [
    ("rig", "rig", dict(), False, "apart", None),
    ("rig_both_paths", "rig", dict(), False, "apart", "median"),
    ("edge_crossing", "random", dict(), False, "apart", None),
    ("out_of_range", "out", dict(), False, "apart", None),
    ("prior_add", "rig", dict(), True, "apart", "median"),
    ("priormul", "rig", dict(priormul=True), True, "apart", "median"),
    ("prior_similarity", "rig", dict(similarity="prior"), True, "apart", "median"),
    ("softmax_off", "rig", dict(softmax_enabled=False), False, "apart", "median"),
    ("detached", "rig", dict(), False, "detached", "median"),
    ("keys_equal_values", "rig", dict(), False, "same", "median"),
]


def _rig_locs(cfg, B):
    """(B, K, h, w, 2) locations of the synthetic rig's view pairs (each
    view with its nearest neighbour, cycled)."""
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(B)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]], dtype=torch.float32)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry)


def _case(kind, use_prior):
    rng = np.random.RandomState(0)
    locs = _rig_locs(flagship_cfg(tiny=True), 4).numpy()
    B, K, H, W, _ = locs.shape
    if kind == "random":
        locs = rng.rand(B, K, H, W, 2).astype(np.float32) * 2.6 - 1.3
    elif kind == "out":
        locs = np.full_like(locs, -9.0)
    feat1, keys, values, dout = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(4))
    prior = rng.rand(B, K, H, W).astype(np.float32) * 0.1 if use_prior else None
    return feat1, keys, values, locs, dout, prior


def _median_cap(locs):
    B, K, H, W, _ = locs.shape
    _, union = attn._tile_plan(torch.from_numpy(locs).reshape(B, K, H * W, 2), H, W, TILE_Q)
    return int(union.sum(-1).median())


def _tiled_grads(feat1, keys, values, locs, dout, kw, prior, cap):
    """dfeat1, dkeys, dvalues and dprior of the tile schedule, the tiles on
    each path; with keys and values one tensor, dkeys is their sum."""
    B, K, H, W, _ = locs.shape
    t = [torch.from_numpy(a).reshape(B, H * W, C) for a in (feat1, keys, values, dout)]
    pr = None if prior is None else torch.from_numpy(prior).reshape(B, K, H * W)
    d1, dk, dv, dp, counts = attn._tiled_backward_core(
        t[0], t[1], t[2], torch.from_numpy(locs).reshape(B, K, H * W, 2), pr, t[3], H, W,
        AttentionParams(**kw), tile_q=TILE_Q,
        max_union=attn.BACKWARD_MAX_UNION if cap is None else cap)
    grads = [g.reshape(B, H, W, C).numpy() for g in (d1, dk, dv)]
    return grads + [None if dp is None else dp.reshape(B, K, H, W).numpy()], counts


def _autograd_grads(feat1, keys, values, locs, dout, kw, prior, kv):
    leaves = [torch.from_numpy(a).requires_grad_(i == 0 or kv != "detached")
              for i, a in enumerate((feat1, keys, values))]
    pr = None if prior is None else torch.from_numpy(prior).requires_grad_()
    if kv == "same":
        leaves[2] = leaves[1]
    out = attn.epipolar_attention_plain_batch(*leaves, torch.from_numpy(locs),
                                              AttentionParams(**kw), pr)[0]
    (out * torch.from_numpy(dout)).sum().backward()
    grads = [np.zeros_like(feat1) if g is None else g.numpy()
             for g in (leaves[0].grad, leaves[1].grad, leaves[2].grad)]
    return grads + [None if pr is None else pr.grad.numpy()]


def _jax_grads(feat1, keys, values, locs, dout, kw, prior, kv):
    params = JParams(**kw)

    def loss(f1, f2k, f2v, p):
        if kv == "detached":
            f2k, f2v = jax.lax.stop_gradient(f2k), jax.lax.stop_gradient(f2v)
        if kv == "same":
            f2v = f2k
        run = jax.vmap(lambda q, k, v, s, pp: epipolar_attention_matmul(q, k, v, s, params, pp)[0])
        return jnp.sum(run(f1, f2k, f2v, jnp.asarray(locs), p) * jnp.asarray(dout))

    args = (jnp.asarray(feat1), jnp.asarray(keys), jnp.asarray(values),
            None if prior is None else jnp.asarray(prior))
    grads = jax.grad(loss, argnums=(0, 1, 2) if prior is None else (0, 1, 2, 3))(*args)
    return [np.asarray(g, np.float32) for g in grads] + ([None] if prior is None else [])


def _close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("reference", ["autograd_plain", "jax_grad_matmul"])
@pytest.mark.parametrize("name,locs,kw,use_prior,kv,cap", CASES, ids=[c[0] for c in CASES])
def test_tiled_backward_matches(reference, name, locs, kw, use_prior, kv, cap):
    feat1, keys, values, locs, dout, prior = _case(locs, use_prior)
    kw = dict(softmax_scale=1 / np.sqrt(locs.shape[1]), **kw)
    if kv == "same":
        values = keys
    ref = _autograd_grads if reference == "autograd_plain" else _jax_grads
    want = ref(feat1, keys, values, locs, dout, kw, prior, kv)
    got, (tile, per_query) = _tiled_grads(feat1, keys, values, locs, dout, kw, prior,
                                          None if cap is None else _median_cap(locs))
    tiles = locs.shape[0] * -(-locs.shape[2] * locs.shape[3] // TILE_Q)
    assert tile + per_query == tiles
    if name == "edge_crossing":
        assert tile == 0  # no lines to group by
    elif cap is None:
        assert tile == tiles
    else:
        assert 0 < tile < tiles
    _close(got[0], want[0], "dfeat1")
    if kv == "same":
        _close(got[1] + got[2], want[1], "dkeys + dvalues")
    elif kv == "apart":
        _close(got[1], want[1], "dkeys")
        _close(got[2], want[2], "dvalues")
    else:  # the query gradient does not depend on whether keys/values get one
        assert np.abs(want[1]).max() == 0.0 and np.abs(want[2]).max() == 0.0
    if use_prior:
        _close(got[3], want[3], "dprior")
    if name == "out_of_range":
        assert all(np.abs(g).max() == 0.0 for g in got[:3])
    elif name != "prior_similarity":
        assert all(np.abs(g).max() > 0.0 for g in got[:3])


def test_tile_counts_follow_the_union_limit():
    """With the cap at the median union, the tiles above it take the
    per-query path and the counts follow the cap; the gradients are the
    same function with any cap (the tile and per-query sums differ in
    order only)."""
    feat1, keys, values, locs, dout, _ = _case("rig", False)
    B, K, H, W, _ = locs.shape
    _, union = attn._tile_plan(torch.from_numpy(locs).reshape(B, K, H * W, 2), H, W, TILE_Q)
    sizes = union.sum(-1)
    limit = int(sizes.median())
    want = int((sizes <= limit).sum())
    kw = dict(softmax_scale=0.5)
    lim, counts = _tiled_grads(feat1, keys, values, locs, dout, kw, None, limit)
    assert counts == (want, sizes.numel() - want) and 0 < want < sizes.numel()
    full, counts = _tiled_grads(feat1, keys, values, locs, dout, kw, None, None)
    assert counts == (sizes.numel(), 0)
    none, counts = _tiled_grads(feat1, keys, values, locs, dout, kw, None, -1)
    assert counts == (0, sizes.numel())
    for which, a, b, c in zip(("dfeat1", "dkeys", "dvalues"), lim, full, none):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6, err_msg=which)
        np.testing.assert_allclose(b, c, rtol=1e-5, atol=1e-6, err_msg=which)


def test_rig_96x96_tiles_fit_the_backward_cap():
    """The 384 px recipes' heatmaps: the rig's 96x96 lines at K=64 and the
    kernel's tile size put at least 95% of the tiles under the backward's
    union cap, while the forward's cap holds about a fifth of them."""
    cfg = update_from_dict(flagship_cfg(), {"DATASETS": {"IMAGE_SIZE": (384, 384)},
                                            "KEYPOINT": {"HEATMAP_SIZE": (96, 96)}})
    locs = _rig_locs(cfg, 8)
    B, K, H, W, _ = locs.shape
    assert (H, W, K) == (96, 96, 64)
    flat = locs.reshape(B, K, H * W, 2)
    assert attn._items_on_lines(flat, H, W).all()
    _, union = attn._tile_plan(flat, H, W, attn.TILE_QUERIES)
    sizes = union.sum(-1)
    held = int((sizes <= attn.BACKWARD_MAX_UNION).sum())
    assert held >= 0.95 * sizes.numel(), (held, sizes.numel())
    assert int((sizes <= attn.MAX_UNION).sum()) < 0.5 * sizes.numel()


def test_backward_tile_counts_sum_over_launches():
    """The wrapper sums each backward launch's tiles on each path, on the
    device, apart from the forward's; a shape the tile schedule does not
    take puts every tile on the per-query path."""
    dev = torch.device("cpu")
    launch = torch.tensor([6, 1, 7, 7], dtype=torch.int32).view(torch.uint8)  # + scratch
    attn.TILE_COUNTS.clear()
    attn.BACKWARD_TILE_COUNTS.clear()
    attn._count_tiles(launch, dev, 7, attn.BACKWARD_TILE_COUNTS)
    attn._count_tiles(None, dev, 4, attn.BACKWARD_TILE_COUNTS)
    assert attn.backward_tile_counts() == (6, 5)
    assert attn.tile_counts() == (0, 0)
    attn.BACKWARD_TILE_COUNTS.clear()
    assert attn.backward_tile_counts() == (0, 0)
