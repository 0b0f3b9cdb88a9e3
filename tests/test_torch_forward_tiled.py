"""The forward kernel's tile schedule in plain PyTorch (`_tiled_forward_core`:
queries ordered by the angle of their epipolar line, tiles of consecutive
queries, the union of each tile's live corner rows, the local Gram, the
sims, N_t and out = N_t V_union) == the plain version (`_plain_core`) and
== the JAX Pallas kernel `epipolar_attention_pallas_batch` in interpret
mode on the CPU, as tests/test_torch_attention.py runs it.

Cases: dot with softmax on and off, an additive prior, priormul, prior
similarity, keys and values in separate tensors, all samples out of range
(exactly zero), small random shapes whose last tile is partial, and real
geometry (the tiny flagship rig, a camera ring).  Tolerance rtol 1e-4 /
atol 1e-5: all sides compute in f32 and differ only in summation order.

At the flagship rig (B=8 views against their nearest, 64x64, K=64) with
the kernel's bins and tile size, the mean union per tile must stay under
256 rows (162 measured at 32 queries a tile, 194 at 64, when this test was
written): a grouping that lost the reuse would fail it.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.epipolar_attention import AttentionParams as JParams
from epipolar_transformers_tpu.ops.epipolar_attention_pallas import epipolar_attention_pallas_batch
from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.models.epipolar import Epipolar
from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams
from epipolar_transformers_tpu_torch.ops.epipolar_sampling import (
    EpipolarGeometry, epipolar_sample_locs)
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
# (name, locations, AttentionParams fields, prior, values apart from keys)
CASES = [
    ("dot", "random", dict(), False, False),
    ("softmax_off", "random", dict(softmax_enabled=False), False, False),
    ("prior_add", "random", dict(), True, False),
    ("priormul", "random", dict(priormul=True), True, False),
    ("prior_similarity", "random", dict(similarity="prior"), True, False),
    ("keys_values_apart", "random", dict(), False, True),
    ("out_of_range", "out", dict(), False, False),
    ("rig", "rig", dict(), False, False),
    ("camera_ring", "ring", dict(), False, False),
]


def _rig_locs(cfg, B):
    """(B, K, H, W, 2) locations of the synthetic rig's view pairs (each
    view with its nearest neighbour, cycled)."""
    ds = SyntheticMultiview(cfg, is_train=False, n_samples=1)
    views = [v % ds.n_views for v in range(B)]
    P1 = torch.as_tensor(ds.rig["KRT"][views], dtype=torch.float32)
    P2 = torch.as_tensor(ds.rig["KRT"][[ds.nearest[v] for v in views]], dtype=torch.float32)
    return epipolar_sample_locs(P1, P2, Epipolar(cfg).geometry)


def _case(rng, camera_ring, kind, use_prior, apart):
    if kind == "rig":
        locs = _rig_locs(flagship_cfg(tiny=True), 4).numpy()
    elif kind == "ring":
        geom = EpipolarGeometry(feat_h=16, feat_w=16, sample_size=16, downsample=4,
                                resize=1.0, correct_normalize=True)
        P = torch.from_numpy(camera_ring["KRT"].astype(np.float32))
        locs = epipolar_sample_locs(P[[0, 2]], P[[1, 3]], geom).numpy()
    else:
        locs = rng.rand(2, 8, 6, 5, 2).astype(np.float32) * 2.6 - 1.3
        if kind == "out":
            locs = np.full_like(locs, -9.0)
    B, K, H, W, _ = locs.shape
    feat = [rng.randn(B, H, W, 4).astype(np.float32) for _ in range(3)]
    if not apart:
        feat[2] = feat[1]
    prior = rng.rand(B, K, H, W).astype(np.float32) * 0.1 if use_prior else None
    return feat, locs, prior


def _tiled(feat, locs, params, prior, tile_q):
    t = [torch.from_numpy(f) for f in feat]
    if feat[2] is feat[1]:
        t[2] = t[1]
    return attn._run(lambda *a: attn._tiled_forward_core(*a, tile_q=tile_q)[:2],
                     *t, torch.from_numpy(locs), params,
                     None if prior is None else torch.from_numpy(prior))


@pytest.mark.parametrize("reference", ["plain", "pallas"])
@pytest.mark.parametrize("name,kind,kw,use_prior,apart", CASES, ids=[c[0] for c in CASES])
def test_tiled_forward_matches(rng, camera_ring, reference, name, kind, kw, use_prior, apart):
    feat, locs, prior = _case(rng, camera_ring, kind, use_prior, apart)
    kw = dict(softmax_scale=1 / np.sqrt(locs.shape[1]), **kw)
    # tiles of 8 queries: several tiles an item, the last one partial at 6x5
    got = _tiled(feat, locs, AttentionParams(**kw), prior, tile_q=8)
    if reference == "plain":
        want = attn.epipolar_attention_plain_batch(
            *[torch.from_numpy(f) for f in feat], torch.from_numpy(locs),
            AttentionParams(**kw), None if prior is None else torch.from_numpy(prior))
        want = [w.numpy() for w in want]
    else:
        want = epipolar_attention_pallas_batch(
            *[jnp.asarray(f) for f in feat], jnp.asarray(locs), JParams(**kw),
            None if prior is None else jnp.asarray(prior))
    for which, g, w in zip(("out", "corr_pos", "depth"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=which)
    if name == "out_of_range":
        assert got[0].abs().max().item() == 0.0
        np.testing.assert_allclose(got[2].numpy(), 1 / locs.shape[1])
    elif name != "prior_similarity":
        assert got[0].abs().max().item() > 0.0


def test_line_bins_group_a_line():
    """Queries on one epipolar line share their samples, hence their key;
    a line without extent takes bin HW."""
    locs = _rig_locs(flagship_cfg(tiny=True), 4)
    B, K, H, W, _ = locs.shape
    flat = locs.reshape(B, K, H * W, 2)
    bins = attn._line_bins(flat, H, W)
    assert bins.shape == (B, H * W) and int(bins.min()) >= 0 and int(bins.max()) <= H * W
    same_line = (flat[:, 0] == flat[:, 0, :1]).all(-1) & (flat[:, -1] == flat[:, -1, :1]).all(-1)
    assert (bins[same_line] == bins[:, :1].expand_as(bins)[same_line]).all()
    out = attn._line_bins(torch.full_like(flat, -9.0), H, W)
    assert (out == H * W).all()


def test_tile_counts_follow_the_union_limit(rng):
    feat, locs, _ = _case(rng, None, "rig", False, False)
    B, K, H, W, _ = locs.shape
    flat = torch.from_numpy(locs).reshape(B, K, H * W, 2)
    args = (*[torch.from_numpy(f).reshape(B, H * W, -1) for f in feat], flat, None, H, W,
            AttentionParams())
    _, union = attn._tile_plan(flat, H, W, 8)
    sizes = union.sum(-1)
    limit = int(sizes.median())
    want = int((sizes <= limit).sum())
    _, _, counts = attn._tiled_forward_core(*args, tile_q=8, max_union=limit)
    assert counts == (want, sizes.numel() - want) and 0 < want < sizes.numel()
    # the per-query tiles compute the same function
    out_all, _, _ = attn._tiled_forward_core(*args, tile_q=8)
    out_lim, _, _ = attn._tiled_forward_core(*args, tile_q=8, max_union=limit)
    torch.testing.assert_close(out_all, out_lim, rtol=0, atol=0)


def test_flagship_rig_union_keeps_the_reuse():
    """The kernel's grouping at the flagship rig: each tile's live corners
    touch far fewer distinct key rows than their hits (~10,800 at 64
    queries), and every tile fits the tile kernel's 256 union rows."""
    locs = _rig_locs(flagship_cfg(), 8)
    B, K, H, W, _ = locs.shape
    flat = locs.reshape(B, K, H * W, 2)
    perm, union = attn._tile_plan(flat, H, W, attn.TILE_QUERIES)
    assert (torch.sort(perm, dim=1).values == torch.arange(H * W)).all()
    sizes = union.sum(-1).float()
    assert sizes.mean().item() < 256, sizes.mean().item()
    assert int((sizes <= attn.MAX_UNION).sum()) == sizes.numel()
    _, wc = attn._corners(flat, H, W)
    hits = (wc != 0).sum().item() / (B * union.shape[1])  # live corner hits per tile
    assert sizes.mean().item() < hits / 40


def test_items_on_lines():
    """Epipolar samples lie on their lines; random locations do not, and
    such items are left to the per-query kernel."""
    rng = np.random.RandomState(0)
    locs = _rig_locs(flagship_cfg(), 2)
    B, K, H, W, _ = locs.shape
    assert attn._items_on_lines(locs.reshape(B, K, H * W, 2), H, W).all()
    rand = torch.from_numpy(rng.rand(B, K, H * W, 2).astype(np.float32) * 2.6 - 1.3)
    assert not attn._items_on_lines(rand, H, W).any()
    _, _, counts = attn._tiled_forward_core(
        torch.zeros(B, H * W, 32), torch.zeros(B, H * W, 32), torch.zeros(B, H * W, 32),
        rand, None, H, W, AttentionParams())
    assert counts == (0, B * H * W // attn.TILE_QUERIES)


def test_tile_counts_sum_over_launches():
    """The wrapper sums each launch's tiles on each path, on the device,
    under inference_mode and with autograd alike; a shape the tile schedule
    does not take puts every tile on the per-query path."""
    dev = torch.device("cpu")
    launch = torch.tensor([5, 2, 7, 7], dtype=torch.int32).view(torch.uint8)  # + scratch
    attn.TILE_COUNTS.clear()
    assert attn.tile_counts() == (0, 0)
    with torch.inference_mode():
        attn._count_tiles(launch, dev, 7)
    attn._count_tiles(launch, dev, 7)
    attn._count_tiles(None, dev, 3)
    assert attn.tile_counts() == (10, 7)
    assert not attn.TILE_COUNTS[dev].is_inference()
    attn.TILE_COUNTS.clear()
    assert attn.tile_counts() == (0, 0)
