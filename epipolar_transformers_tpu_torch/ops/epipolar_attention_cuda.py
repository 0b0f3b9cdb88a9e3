"""Fused epipolar attention: the hand-written Hopper kernels and their plain twin.

Counterpart of epipolar_transformers_tpu/ops/epipolar_attention_pallas.py
(`_make_kernel`, launched by `_pallas_attention`, wrapper
`epipolar_attention_pallas_batch`).  The CUDA forward in
csrc/epipolar_attention.cu computes what the TPU kernel and the two XLA
matmuls around it compute together: from the query, key and value features
and the sample locations straight to `out` and `depth`, without the
(HW, HW) Gram matrix or weight matrix ever reaching memory.  The CUDA
backward in the same file has no TPU counterpart (the JAX package trains by
`jax.grad` of its XLA matmul path) and is held to autograd of the plain
twin.  The source note says what bounds each and what the design does
about that.

`epipolar_attention_batch` is the wrapper the model calls: on CPU tensors
it runs the plain PyTorch version, differentiated by autograd; on CUDA
tensors it runs `EpipolarAttentionFn`, whose forward launches the forward
kernels (counted once a call in `LAUNCHES`; the tiles on each path summed
in `TILE_COUNTS`, read by `tile_counts()`) and whose backward launches the
backward kernels (counted in `BACKWARD_LAUNCHES`; its tiles on each path
summed in `BACKWARD_TILE_COUNTS`, read by `backward_tile_counts()`), or
raises.
`epipolar_attention_plain_batch` is the plain version on any device: the
Gram + corner-gather form with `torch.matmul`, mirroring the JAX math; the
CPU tests hold it to the JAX kernel and to `jax.grad` of the matmul path,
and the chip check holds both kernels to it.  `_tiled_forward_core`,
`_tiled_backward_core` and `_transposed_backward_core` restate the kernels'
own schedules in plain PyTorch, so that the CPU tests can check their math.

Coverage is the TPU kernel's (`supports_pallas_attention`): avg attention
over dot or prior similarity, softmax on or off, an additive prior or
`priormul`, no sample pooling.  The additive prior under the softmax is the
JAX package's masked softmax (ops/epipolar_attention.py:
`epipolar_similarity_weights`).  A prior that needs a gradient (the learned
EPIPOLAR.PRIOR table) gets it from the backward kernel: (B, K, HW), each
entry written by the lane that owns its (query, sample).  The other configs
(cos/max, POOLING) run the plain paths of ops/epipolar_attention.py.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..geometry.camera import denormalize_pixel
from ..utils import tracing
from .epipolar_attention import AttentionParams, epipolar_similarity_weights
from .quad_gather import corner_data

# kernel launches made by `epipolar_attention_batch` in this process:
# forward kernels, and backward kernels run by autograd
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# the forward launches' tiles on each path, (tile path, per-query path),
# summed on each device into an int64 tensor keyed by the device; clear() it
# to start counting again.  BACKWARD_TILE_COUNTS: the same for the backward
# launches' tiles
TILE_COUNTS: dict = {}
BACKWARD_TILE_COUNTS: dict = {}
# tracing (utils/tracing.py) clears them when it turns on and sums them at drain
tracing.register_device_counts(TILE_COUNTS, ("attn.forward_tiles.tile_path",
                                             "attn.forward_tiles.per_query_path"))
tracing.register_device_counts(BACKWARD_TILE_COUNTS, ("attn.backward_tiles.tile_path",
                                                      "attn.backward_tiles.per_query_path"))

KERNEL_CHANNELS = (32, 64, 128, 256)


def supports_fused_attention(params: AttentionParams) -> bool:
    """Configs the fused kernel covers: avg attention over dot or prior
    similarity, without sample pooling."""
    return (
        params.attention == "avg"
        and params.similarity in ("dot", "prior")
        and not params.pooling
    )


def _check_params(params: AttentionParams) -> None:
    if not supports_fused_attention(params):
        raise ValueError(
            f"fused epipolar attention covers avg attention with dot or prior "
            f"similarity and no pooling, not {params}; the other configs take "
            "ops/epipolar_attention.py")


def _compute_dtype(f1: torch.Tensor, f2k: torch.Tensor) -> torch.dtype:
    """bf16 if either is, else f32; f64 queries (the CPU tests' f64 runs,
    which the kernels refuse) stay f64."""
    if torch.bfloat16 in (f1.dtype, f2k.dtype):
        return torch.bfloat16
    return torch.float64 if f1.dtype == torch.float64 else torch.float32


def _flat(feat1, other1, other2, sample_locs, prior):
    """NHWC features -> (B, HW, C) in the compute dtype, locations ->
    (B, K, HW, 2) f32, prior -> (B, K, HW) f32 (f64 with f64 features)."""
    B, H, W, _ = feat1.shape
    K = sample_locs.shape[1]
    cd = _compute_dtype(feat1, other1)
    f1 = feat1.reshape(B, H * W, -1).to(cd)
    f2k = other1.reshape(B, H * W, -1).to(cd)
    # one tensor for keys and values stays one object, so that the backward
    # can sum both gradients into one buffer
    f2v = f2k if other2 is other1 else other2.reshape(B, H * W, -1).to(cd)
    locs = sample_locs.reshape(B, K, H * W, 2).to(torch.float32)
    acc = torch.promote_types(cd, torch.float32)
    prior = None if prior is None else prior.reshape(B, K, H * W).to(acc)
    return f1, f2k, f2v, locs, prior


def _finish(out, depth, sample_locs, other2, params):
    """(B, HW, Cv) f32 out and (B, K, HW) f32 weights -> the JAX wrapper's
    contract: out (B, H, W, Cv) in other2's dtype, corr_pos (B, H, W, 2) at
    each pixel's highest-weight sample, depth (B, K, H, W)."""
    B, K, H, W, _ = sample_locs.shape
    HW = H * W
    out = out.reshape(B, H, W, -1).to(other2.dtype)
    best = torch.argmax(depth, dim=1)  # (B, HW), first maximum on ties
    locs = sample_locs.reshape(B, K, HW, 2)
    pos = torch.gather(locs, 1, best[:, None, :, None].expand(B, 1, HW, 2))[:, 0]
    corr_pos = denormalize_pixel(pos.reshape(B, H, W, 2), H, W,
                                 correct=params.correct_normalize)
    return out, corr_pos, depth.reshape(B, K, H, W)


def _corners(locs, H, W):
    """Corner key rows and bilinear weights (B, HW, K, 4) of every sample,
    in the kernels' slot order (00, 01, 10, 11).  A zero-weight corner may
    fall off the image; its row is clamped to a harmless in-range index."""
    rows, wc = corner_data(locs, H, W)
    return rows.permute(0, 2, 1, 3), wc.permute(0, 2, 1, 3)


def _weights(sim, prior_q, params):
    """Zero-sentinel mask, additive prior (the masked softmax), softmax or
    1/K, prior multiply: similarities (B, HW, K) -> attention weights."""
    if params.similarity == "prior":
        return prior_q
    return epipolar_similarity_weights(sim, params, prior_q, dim=-1)


def _plain_core(f1, f2k, f2v, locs, prior, H, W, params):
    """Gram + corner-gather form: G = f1 f2k^T, the four corner columns of
    G weighted into the similarity, then a scatter of the attention weights
    into n (B, HW, HW) and out = n f2v.  Returns out (B, HW, Cv) and depth
    (B, K, HW) in f32 (f64 for f64 features)."""
    B, K, HW, _ = locs.shape
    acc = torch.promote_types(f1.dtype, torch.float32)
    rows, wc = _corners(locs, H, W)
    idx = rows.reshape(B, HW, K * 4)
    prior_q = None if prior is None else prior.permute(0, 2, 1)  # (B, HW, K)

    sim = None
    if params.similarity != "prior":
        G = torch.matmul(f1, f2k.transpose(1, 2))  # (B, HW, HW) compute dtype
        sim = (torch.gather(G, 2, idx).to(acc).reshape(B, HW, K, 4) * wc).sum(-1)
    w = _weights(sim, prior_q, params)

    n = torch.zeros(B, HW, HW, dtype=acc, device=f1.device)
    n.scatter_add_(2, idx, (w[..., None] * wc).reshape(B, HW, K * 4).to(acc))
    out = torch.matmul(n.to(f2v.dtype), f2v).to(acc)
    return out, w.permute(0, 2, 1).contiguous()


# The forward kernel's tile schedule (csrc/epipolar_attention.cu: kTileQ,
# kMaxUnion) and the backward's own union cap (kBwdUnion); the test on the
# card holds these equal to the library's
TILE_QUERIES = 64
MAX_UNION = 256
BACKWARD_MAX_UNION = 320


def _line_bins(locs, H, W):
    """(B, HW) line key of every query, as the grouping kernel computes it:
    the angle in [0, pi) of the segment from its first to its last sample,
    in HW bins; a line without extent (it misses the image, so every sample
    sits at the far sentinel; or K == 1) takes bin HW."""
    HW = H * W
    x = (locs[..., 0] + 1.0) / 2.0 * (W - 1)
    y = (locs[..., 1] + 1.0) / 2.0 * (H - 1)
    dx, dy = x[:, -1] - x[:, 0], y[:, -1] - y[:, 0]
    a = torch.atan2(dy, dx)
    a = torch.where(a < 0, a + math.pi, a)
    bins = (a * float(np.float32(HW / math.pi))).to(torch.int64).clamp(0, HW - 1)
    return torch.where((dx == 0) & (dy == 0), torch.full_like(bins, HW), bins)


def _items_on_lines(locs, H, W):
    """(B,) bool: whether at least half an item's queries have their samples
    on a line, as the grouping kernel tests it (the middle sample within half
    a pixel of its place on the segment from the first to the last).  Other
    items (random locations) are not grouped: all their tiles take the
    per-query kernel."""
    B, K, HW, _ = locs.shape
    if K < 3:
        return torch.ones(B, dtype=torch.bool, device=locs.device)
    scale = torch.tensor([0.5 * (W - 1), 0.5 * (H - 1)], dtype=torch.float32,
                         device=locs.device)
    first, mid, last = locs[:, 0] * scale, locs[:, K // 2] * scale, locs[:, -1] * scale
    t = np.float32(K // 2) / np.float32(K - 1)
    near = ((first + (last - first) * float(t) - mid).abs() <= 0.5).all(-1)
    return 2 * near.sum(-1) >= HW


def _tile_plan(locs, H, W, tile_q=TILE_QUERIES):
    """The forward kernel's grouping and row unions.  Returns perm (B, HW):
    each item's queries ordered by line key, ties by query index (the
    counting sort); and union (B, tiles, HW) bool: the key rows that the
    live corners (w_c != 0) of each tile of tile_q consecutive queries of
    that order touch."""
    B, K, HW, _ = locs.shape
    perm = torch.argsort(_line_bins(locs, H, W), dim=1, stable=True)
    rows, wc = _corners(locs, H, W)
    rows = torch.where(wc != 0, rows, torch.full_like(rows, HW)).reshape(B, HW, K * 4)
    rows = torch.gather(rows, 1, perm[..., None].expand(B, HW, K * 4))
    tiles = -(-HW // tile_q)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, tiles * tile_q - HW), value=HW)
    rows = rows.reshape(B, tiles, tile_q * K * 4)
    union = torch.zeros(B, tiles, HW + 1, dtype=torch.bool, device=locs.device)
    union.scatter_(2, rows, True)
    return perm, union[..., :HW]


def _tiled_forward_core(f1, f2k, f2v, locs, prior, H, W, params,
                        tile_q=TILE_QUERIES, max_union=MAX_UNION):
    """The forward kernel's tile schedule in plain PyTorch, f32: queries
    ordered by line key and cut into tiles of tile_q; per tile the union of
    its live corner rows in row order, the local Gram G_t = f1[tile]
    f2k[union]^T, sim[q, k] = sum_c w_c G_t[q, slot(row_c)], the weights,
    N_t[q, slot] = sum_{k,c} w_k w_c, and out = N_t f2v[union].  A tile whose
    union exceeds max_union, or whose item's samples do not lie on lines,
    takes the per-query kernel on the card; its sum is the same function,
    so here it runs the same form.  Nothing on the main path calls this: it
    checks the design's math on the CPU.  Returns out (B, HW, C) f32, depth
    (B, K, HW) f32 and the tiles on each path (tile path, per-query path)."""
    B, K, HW, _ = locs.shape
    f1, f2k, f2v = (t.float() for t in (f1, f2k, f2v))
    perm, union = _tile_plan(locs, H, W, tile_q)
    rows, wc = _corners(locs, H, W)
    prior_q = None if prior is None else prior.permute(0, 2, 1)
    out = torch.zeros(B, HW, f1.shape[-1], dtype=torch.float32, device=f1.device)
    depth = torch.zeros(B, HW, K, dtype=torch.float32, device=f1.device)
    sizes = union.sum(-1)
    for b in range(B):
        for t in range(union.shape[1]):
            qs = perm[b, t * tile_q:(t + 1) * tile_q]
            urows = torch.nonzero(union[b, t])[:, 0]  # row order
            U = len(urows)
            # a dead corner (w_c = 0) points at an extra zero column U
            slot_of = torch.full((HW,), U, dtype=torch.int64, device=f1.device)
            slot_of[urows] = torch.arange(U, device=f1.device)
            live = wc[b, qs]
            slot = torch.where(live != 0, slot_of[rows[b, qs]], U).reshape(len(qs), -1)
            sim = None
            if params.similarity != "prior":
                G = torch.nn.functional.pad(f1[b, qs] @ f2k[b, urows].T, (0, 1))  # (q, U + 1)
                sim = (torch.gather(G, 1, slot).reshape(live.shape) * live).sum(-1)
            pq = None if prior_q is None else prior_q[b, qs][None]
            w = _weights(None if sim is None else sim[None], pq, params)[0]
            N = torch.zeros(len(qs), U + 1, dtype=torch.float32, device=f1.device)
            N.scatter_add_(1, slot, (w[..., None] * live).reshape(len(qs), -1))
            out[b, qs] = N[:, :U] @ f2v[b, urows]
            depth[b, qs] = w
    tile_path = int(((sizes <= max_union) & _items_on_lines(locs, H, W)[:, None]).sum())
    return out, depth.permute(0, 2, 1).contiguous(), (tile_path, sizes.numel() - tile_path)


def _logit_grads(sim, g, prior_q, params):
    """The backward's per-sample rules (the header of
    csrc/epipolar_attention.cu): similarities sim (None under similarity
    'prior') and g = dL/dw (..., K) -> the weights w, the logit gradients ds
    and the prior's gradient (None without a prior)."""
    K = g.shape[-1]
    if params.similarity == "prior":
        return prior_q, torch.zeros_like(g), g
    w = _weights(sim, prior_q, params)
    mul = prior_q is not None and params.priormul
    dprior = None
    if params.softmax_enabled:
        # the softmax before the prior multiply (1/K on a row with no
        # valid slot, whose weights are a constant)
        p = _weights(sim, None, params) if mul else w
        gp = g * prior_q if mul else g
        ds = params.softmax_scale * p * (gp - (p * gp).sum(-1, keepdim=True))
        ds = torch.where(sim == 0.0, torch.zeros_like(ds), ds)
        if prior_q is not None:
            dprior = g * p if mul else ds
    else:
        ds = torch.where(sim == 0.0, torch.zeros_like(g), g / K)
        if prior_q is not None:
            # (masked + p) / K is linear in p on every slot, dead ones too
            dprior = torch.zeros_like(g) if mul else g / K
    return w, ds, dprior


def _transposed_backward_core(f1, f2k, f2v, locs, prior, dout, H, W, params, queries=None):
    """The backward kernels' three passes in plain PyTorch, f32: per query
    the weights w, the logit gradients ds, dfeat1 and the prior's gradient
    (pass A); the entries (row, q, ds w_c, w w_c) of every corner with
    w_c != 0, in (q, k, c) order, stably sorted by key row (pass B); their
    sums per row (pass C).  `queries` (B, HW) bool keeps the entries of
    those queries only, as the CSR passes keep the queries the tile path
    left.  Returns dfeat1, dother1, dother2 (B, HW, C) f32 and dprior
    (B, K, HW) f32, or None without a prior."""
    B, K, HW, _ = locs.shape
    f1, f2k, f2v, dout = (t.float() for t in (f1, f2k, f2v, dout))
    rows, wc = _corners(locs, H, W)
    rows = torch.where(wc != 0, rows, torch.zeros_like(rows))  # (B, HW, K, 4)
    items = torch.arange(B, device=f1.device)[:, None, None, None]

    def corners(feat):  # (B, HW, K, 4, C) corner rows
        return feat[items, rows]

    def corner_dot(feat, vec):  # sum_c w_c <vec[q], feat[corner_c]>
        return (wc * (corners(feat) * vec[:, :, None, None, :]).sum(-1)).sum(-1)

    prior_q = None if prior is None else prior.float().permute(0, 2, 1)  # (B, HW, K)
    g = corner_dot(f2v, dout)
    sim = None if params.similarity == "prior" else corner_dot(f2k, f1)
    w, ds, dprior = _logit_grads(sim, g, prior_q, params)
    dfeat1 = ((ds[..., None] * wc)[..., None] * corners(f2k)).sum((2, 3))

    live = wc if queries is None else wc * queries[:, :, None, None]
    b, q, k, c = torch.nonzero(live, as_tuple=True)  # (q, k, c) order per item
    key_row = b * HW + rows[b, q, k, c]
    order = torch.argsort(key_row, stable=True)
    key_row, b, q, k, c = (t[order] for t in (key_row, b, q, k, c))
    weight = wc[b, q, k, c]

    def row_sums(coef, feat):
        out = torch.zeros(B * HW, f1.shape[-1], dtype=torch.float32, device=f1.device)
        out.index_add_(0, key_row, (coef[b, q, k] * weight)[:, None] * feat[b, q])
        return out.reshape(B, HW, -1)

    dprior = None if dprior is None else dprior.permute(0, 2, 1).contiguous()
    return dfeat1, row_sums(ds, f1), row_sums(w, dout), dprior


def _tiled_backward_core(f1, f2k, f2v, locs, prior, dout, H, W, params,
                         tile_q=TILE_QUERIES, max_union=BACKWARD_MAX_UNION):
    """The backward kernel's tile schedule in plain PyTorch, f32: the
    forward's grouping and tiles (`_tile_plan`); per tile whose union holds
    at most max_union rows and whose item's samples lie on lines, the local
    products G_t = f1[tile] K_U^T and Gd_t = dout[tile] V_U^T, sim and g
    from their live-corner slots, w and ds by the per-query rules,
    D_t[q, slot] = sum_{k,c} ds_k w_c and N_t[q, slot] = sum_{k,c} w_k w_c,
    dfeat1 = D_t K_U, and the key/value partials D_t^T f1[tile] and N_t^T
    dout[tile] on the union's rows; each key row sums its tiles' partials
    in tile order, then adds the entries of the queries the tile path left,
    through `_transposed_backward_core` restricted to them (which also gives
    those queries' dfeat1 and dprior).  Nothing on the main path calls this:
    it checks the design's math on the CPU.  Returns dfeat1, dother1,
    dother2 (B, HW, C) f32, dprior (B, K, HW) f32 or None, and the tiles on
    each path (tile path, per-query path)."""
    B, K, HW, _ = locs.shape
    f1, f2k, f2v, dout = (t.float() for t in (f1, f2k, f2v, dout))
    perm, union = _tile_plan(locs, H, W, tile_q)
    sizes = union.sum(-1)
    taken = (sizes <= max_union) & _items_on_lines(locs, H, W)[:, None]
    rows, wc = _corners(locs, H, W)
    prior_q = None if prior is None else prior.float().permute(0, 2, 1)  # (B, HW, K)
    left = torch.ones(B, HW, dtype=torch.bool, device=f1.device)
    dfeat1 = torch.zeros_like(f1)
    dk = torch.zeros(B, HW, f1.shape[-1], dtype=torch.float32, device=f1.device)
    dv = torch.zeros_like(dk)
    dprior = None if prior is None else torch.zeros(B, HW, K, dtype=torch.float32,
                                                    device=f1.device)
    for b in range(B):
        for t in range(union.shape[1]):
            if not taken[b, t]:
                continue
            qs = perm[b, t * tile_q:(t + 1) * tile_q]
            left[b, qs] = False
            urows = torch.nonzero(union[b, t])[:, 0]  # row order
            U = len(urows)
            # a dead corner (w_c = 0) points at an extra zero column U
            slot_of = torch.full((HW,), U, dtype=torch.int64, device=f1.device)
            slot_of[urows] = torch.arange(U, device=f1.device)
            live = wc[b, qs]
            slot = torch.where(live != 0, slot_of[rows[b, qs]], U).reshape(len(qs), -1)

            def at_slots(M):  # sum_c w_c M[q, slot(k, c)], (q, K)
                M = torch.nn.functional.pad(M, (0, 1))
                return (torch.gather(M, 1, slot).reshape(live.shape) * live).sum(-1)

            g = at_slots(dout[b, qs] @ f2v[b, urows].T)
            sim = None if params.similarity == "prior" else at_slots(f1[b, qs] @ f2k[b, urows].T)
            pq = None if prior_q is None else prior_q[b, qs]
            w, ds, dp = _logit_grads(sim, g, pq, params)

            def slot_sums(coef):  # (q, U): sum_{k,c} coef_k w_c per slot
                M = torch.zeros(len(qs), U + 1, dtype=torch.float32, device=f1.device)
                M.scatter_add_(1, slot, (coef[..., None] * live).reshape(len(qs), -1))
                return M[:, :U]

            D, N = slot_sums(ds), slot_sums(w)
            dfeat1[b, qs] = D @ f2k[b, urows]
            dk[b, urows] += D.T @ f1[b, qs]
            dv[b, urows] += N.T @ dout[b, qs]
            if dprior is not None:
                dprior[b, qs] = dp
    d1, rk, rv, rp = _transposed_backward_core(f1, f2k, f2v, locs, prior, dout, H, W, params,
                                               queries=left)
    dfeat1 = torch.where(left[..., None], d1, dfeat1)
    if dprior is not None:
        dprior = torch.where(left[:, None], rp, dprior.permute(0, 2, 1))
    tile_path = int(taken.sum())
    return dfeat1, dk + rk, dv + rv, dprior, (tile_path, sizes.numel() - tile_path)


def epipolar_attention_backward_plain(feat1, other1, other2, sample_locs,
                                      params: AttentionParams, dout, prior=None):
    """The gradients of sum(out * dout) with respect to feat1, other1 and
    other2 (each (B, H, W, C) f32) and the prior ((B, K, H, W) f32, None
    without one), computed as the CUDA backward computes them: the
    key/value gradients as per-row sums of transposed entries rather than
    a scatter.  The tests hold it to autograd of the plain version and to
    jax.grad of the JAX matmul path."""
    _check_params(params)
    B, H, W, _ = feat1.shape
    f1, f2k, f2v, locs, prior_flat = _flat(feat1, other1, other2, sample_locs.detach(), prior)
    *grads, dprior = _transposed_backward_core(f1, f2k, f2v, locs, prior_flat,
                                               dout.reshape(B, H * W, -1), H, W, params)
    grads = [t.reshape(B, H, W, -1) for t in grads]
    return (*grads, None if dprior is None else dprior.reshape(B, -1, H, W))


def _summed(counts: dict) -> tuple[int, int]:
    total = [0, 0]
    for pair in counts.values():
        for i, n in enumerate(pair.tolist()):
            total[i] += n
    return total[0], total[1]


def tile_counts() -> tuple[int, int]:
    """The forward's tiles on the tile path and on the per-query path,
    summed over the launches since `TILE_COUNTS` was cleared, on every
    device (this syncs with them)."""
    return _summed(TILE_COUNTS)


def backward_tile_counts() -> tuple[int, int]:
    """The backward's tiles on the tile path and on the per-query path,
    summed over the launches since `BACKWARD_TILE_COUNTS` was cleared, on
    every device (this syncs with them)."""
    return _summed(BACKWARD_TILE_COUNTS)


def _count_tiles(scratch, device, tiles: int, counts: dict = TILE_COUNTS) -> None:
    """Add one launch's tiles to `counts` (`TILE_COUNTS`, or
    `BACKWARD_TILE_COUNTS`), on the device: the kernels leave them in the
    scratch's first two ints; without scratch (the tile schedule does not
    take the shape) every tile takes the per-query kernel."""
    pair = counts.get(device)
    if pair is None:
        # a normal tensor even under inference_mode, so that later forwards
        # with autograd may add to it
        with torch.inference_mode(False):
            pair = counts[device] = torch.zeros(2, dtype=torch.int64, device=device)
    if scratch is None:
        pair[1] += tiles
    else:
        pair += scratch[:8].view(torch.int32)


def _kernel_args(f1, f2k, f2v, locs, prior, params):
    """Check the inputs against what the kernels take; returns the library
    and the (pointers, sizes, flags) the C entry points share."""
    from ._build import load_library

    B, K, HW, _ = locs.shape
    C = f1.shape[-1]
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel takes f32 or bf16 features, got {f1.dtype}")
    if f2k.shape[-1] != C or f2v.shape[-1] != C or C not in KERNEL_CHANNELS:
        raise ValueError(
            f"the CUDA kernel takes equal query, key and value widths in "
            f"{KERNEL_CHANNELS}, got {f1.shape[-1]}, {f2k.shape[-1]}, {f2v.shape[-1]}")
    lib = load_library("epipolar_attention")
    if not 1 <= K <= lib.epipolar_attention_max_samples():
        raise ValueError(f"the CUDA kernel takes at most "
                         f"{lib.epipolar_attention_max_samples()} samples, got {K}")
    for t in [f1, f2k, f2v, locs] + ([] if prior is None else [prior]):
        if t.device != f1.device:
            raise ValueError("all attention inputs must lie on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned inputs")
    pointers = [f1.data_ptr(), f2k.data_ptr(), f2v.data_ptr(), locs.data_ptr(),
                None if prior is None else prior.data_ptr()]
    flags = [float(params.softmax_scale), int(params.similarity != "prior"),
             int(params.softmax_enabled), int(params.priormul)]
    return lib, pointers, flags


def _kernel_core(f1, f2k, f2v, locs, prior, H, W, params):
    """Launch the forward kernels of csrc/epipolar_attention.cu on the
    current stream: the grouping, the tile kernel and the per-query kernel
    for the tiles it leaves, or the per-query kernel alone where the tile
    schedule does not take the shape.  `TILE_COUNTS` receives the tiles on
    each path, on the device.  The arguments, scratch and launch run in the
    `epipolar.attention` span (utils/tracing.py), whose CUDA events bracket
    the launch."""
    global LAUNCHES
    with tracing.span("epipolar.attention", device=True):
        lib, pointers, flags = _kernel_args(f1, f2k, f2v, locs, prior, params)
        B, K, HW, _ = locs.shape
        C = f1.shape[-1]
        out = torch.empty(B, HW, C, dtype=torch.float32, device=f1.device)
        depth = torch.empty(B, K, HW, dtype=torch.float32, device=f1.device)
        size = lib.epipolar_attention_forward_scratch_bytes
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
        nbytes = size(B, H, W)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=f1.device) if nbytes else None
        fn = lib.epipolar_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tracing.launching()
        err = fn(*pointers, out.data_ptr(), depth.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 B, H, W, K, C, int(f1.dtype == torch.bfloat16), *flags,
                 torch.cuda.current_stream(f1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"epipolar_attention_forward failed: CUDA error {err}")
    LAUNCHES += 1
    _count_tiles(scratch, f1.device, B * -(-HW // TILE_QUERIES))
    return out, depth


def _kernel_backward(f1, f2k, f2v, locs, prior, dout, H, W, params,
                     need_keys: bool, need_values: bool, same_kv: bool,
                     need_prior: bool = False, max_union: int = BACKWARD_MAX_UNION):
    """Launch the backward kernels of csrc/epipolar_attention.cu on the
    current stream: the grouping, the tile kernel, the per-query pass and
    the CSR passes for the queries it leaves, and the row reduction; or the
    per-query and CSR passes alone where the tile schedule does not take the
    shape.  Returns f32 (dfeat1, dother1 or None, dother2 or None, dprior or
    None); when the keys and values are one tensor (same_kv) and both
    gradients are wanted, dother1 is their sum and dother2 None; dprior
    (B, K, HW) when need_prior.  Every row of each gradient is written by
    the kernels; their scratch comes from here.  A tile whose union exceeds
    max_union rows takes the per-query passes (a check may lower it to put
    both paths in one launch).  `BACKWARD_TILE_COUNTS` receives the tiles
    on each path, on the device.  The arguments, scratch and launch run in
    the `epipolar.attention_backward` span (utils/tracing.py), whose CUDA
    events bracket the launch."""
    global BACKWARD_LAUNCHES
    with tracing.span("epipolar.attention_backward", device=True):
        lib, pointers, flags = _kernel_args(f1, f2k, f2v, locs, prior, params)
        B, K, HW, _ = locs.shape
        C = f1.shape[-1]
        if need_keys or need_values:
            # one shared-memory cursor per key row; int32 entry offsets; the
            # query index in an entry's upper 23 bits
            rows = lib.epipolar_attention_max_key_rows()
            if HW > rows or B * HW * K * 4 >= 2 ** 31 or B * HW >= 2 ** 23:
                raise ValueError(f"the CUDA backward of the key/value gradients takes H*W <= "
                                 f"{rows}, B*H*W*K*4 < 2**31 and B*H*W < 2**23, got B={B}, "
                                 f"H*W={HW}, K={K}")
        tiled = bool(lib.epipolar_attention_tile_shape(B, H, W))
        dout = dout.to(torch.float32).contiguous()
        dfeat1 = torch.empty(B, HW, C, dtype=torch.float32, device=f1.device)
        fused = same_kv and need_keys and need_values
        dother1 = torch.empty_like(dfeat1) if need_keys else None
        dother2 = None if fused else torch.empty_like(dfeat1) if need_values else None
        dprior = torch.empty(B, K, HW, dtype=torch.float32, device=f1.device) \
            if need_prior else None
        partials = 0 if dother1 is None and dother2 is None else \
            2 if dother1 is not None and dother2 is not None else 1
        size = lib.epipolar_attention_backward_scratch_bytes
        size.argtypes = [ctypes.c_int] * 6
        size.restype = ctypes.c_longlong
        nbytes = size(B, H, W, K, C, partials)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=f1.device) if nbytes else None
        fn = lib.epipolar_attention_backward
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptr = [None if t is None else t.data_ptr() for t in (dother1, dother2, dprior, scratch)]
        if fused:
            ptr[1] = ptr[0]
        tracing.launching()
        err = fn(*pointers, dout.data_ptr(), dfeat1.data_ptr(), *ptr,
                 B, H, W, K, C, int(f1.dtype == torch.bfloat16), *flags, max_union,
                 torch.cuda.current_stream(f1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"epipolar_attention_backward failed: CUDA error {err}")
    BACKWARD_LAUNCHES += 1
    _count_tiles(scratch if tiled else None, f1.device, B * -(-HW // TILE_QUERIES),
                 BACKWARD_TILE_COUNTS)
    return dfeat1, dother1, dother2, dprior


class EpipolarAttentionFn(torch.autograd.Function):
    """The CUDA kernels under autograd: (f1, f2k, f2v) (B, HW, C), locs
    (B, K, HW, 2) and prior (B, K, HW) or None -> out (B, HW, C) f32 and
    depth (B, K, HW) f32.

    The backward keeps only the inputs: it recomputes the slot data, the
    similarities and the queries' grouping by line (~0.03 ms at the
    flagship shape) rather than storing any (B, HW, K) intermediate or the
    forward's query order.  Gradients flow to the three features; the key
    and value gradients are computed only when autograd asks for them.  Under OTHER_GRAD the keys and the
    values are one tensor: the kernels then return the sum of both
    gradients once, as the keys' gradient.  A prior that needs a gradient
    (the learned EPIPOLAR.PRIOR table) gets it, (B, K, HW) f32.  `depth`
    and the locations carry none.
    """

    @staticmethod
    def forward(ctx, f1, f2k, f2v, locs, prior, H, W, params):
        out, depth = _kernel_core(f1, f2k, f2v, locs, prior, H, W, params)
        ctx.save_for_backward(f1, f2k, f2v, locs, prior)
        ctx.geometry = (H, W, params)
        ctx.same_kv = f2k is f2v
        ctx.mark_non_differentiable(depth)
        return out, depth

    @staticmethod
    def backward(ctx, dout, _ddepth):
        f1, f2k, f2v, locs, prior = ctx.saved_tensors
        H, W, params = ctx.geometry
        dfeat1, dother1, dother2, dprior = _kernel_backward(
            f1, f2k, f2v, locs, prior, dout, H, W, params,
            need_keys=ctx.needs_input_grad[1], need_values=ctx.needs_input_grad[2],
            same_kv=ctx.same_kv, need_prior=ctx.needs_input_grad[4])

        def cast(g, like):
            return None if g is None else g.to(like.dtype)

        return (cast(dfeat1, f1), cast(dother1, f2k), cast(dother2, f2v),
                None, cast(dprior, prior), None, None, None)


def _run(core, feat1, other1, other2, sample_locs, params, prior):
    _check_params(params)
    if params.similarity == "prior" and prior is None:
        raise ValueError("similarity 'prior' needs a prior")
    B, H, W, _ = feat1.shape
    sample_locs = sample_locs.detach()
    f1, f2k, f2v, locs, prior_flat = _flat(feat1, other1, other2, sample_locs, prior)
    out, depth = core(f1, f2k, f2v, locs, prior_flat, H, W, params)
    return _finish(out, depth, sample_locs, other2, params)


def epipolar_attention_plain_batch(feat1, other1, other2, sample_locs,
                                   params: AttentionParams, prior=None):
    """The plain PyTorch version, on any device (same contract as
    `epipolar_attention_batch`)."""
    return _run(_plain_core, feat1, other1, other2, sample_locs, params, prior)


def epipolar_attention_batch(feat1, other1, other2, sample_locs,
                             params: AttentionParams, prior=None):
    """Fused epipolar attention, the counterpart of
    `epipolar_attention_pallas_batch`.

    Args:
        feat1/other1/other2: (B, H, W, C) query, key and value features.
        sample_locs: (B, K, H, W, 2) normalized (-1, 1) locations.
        prior: optional (B, K, H, W) per-pair prior.
    Returns:
        out (B, H, W, Cv) in other2's dtype, corr_pos (B, H, W, 2),
        depth (B, K, H, W) f32.

    CPU tensors take the plain version (differentiated by autograd); CUDA
    tensors launch the forward kernel, and autograd the backward kernel.
    """
    if feat1.device.type == "cpu":
        core = _plain_core
    elif feat1.device.type == "cuda":
        core = EpipolarAttentionFn.apply
        # the kernel reads (B, H, W, C) rows in place: a channels_last
        # (B, C, H, W) activation permuted to NHWC is contiguous; anything
        # else would be copied on every call, so refuse it
        for name, t in (("feat1", feat1), ("other1", other1), ("other2", other2),
                        ("sample_locs", sample_locs), ("prior", prior)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"the CUDA kernel needs a contiguous {name} (NHWC, i.e. "
                                 f"channels_last activations), got strides {t.stride()}")
    else:
        raise ValueError(f"no epipolar attention for device {feat1.device}")
    return _run(core, feat1, other1, other2, sample_locs, params, prior)
