"""Epipolar attention in plain PyTorch: the oracle, and every config the
CUDA kernel does not cover.

Port of epipolar_transformers_tpu/ops/epipolar_attention.py (reference
modeling/layers/epipolar.py:188-247, 272-321): `AttentionParams`,
`NEG_INF`, `COS_EPS`, `epipolar_similarity_weights` and the two-pass
attention, batched over N with corner gathers instead of a loop over
items.  Each of the K samples of a query is the bilinear sample of the
other view at its location (zero outside the image); with POOLING the
pairs (k, k + K/2) are max-reduced on the features.  Avg attention weighs
the samples by the similarity weights (dot or cos similarity, or the prior
itself); max attention takes the sample of the highest cosine, as one-hot
weights, and returns the cosine stack as `depth`.

Cosine follows the JAX matmul path (epipolar_transformers_tpu/ops/
epipolar_attention_matmul.py:309-334), the path the JAX package trains
cos/max through: the squared norm of a bilinear sample is floored at 1e-24
before the square root.  The forward is the oracle's (the COS_EPS clamp
dominates), and a fully out-of-range sample gets a zero gradient instead
of a NaN.

`epipolar_attention` is the layer's plain path (models/epipolar.py says
when it runs); ops/epipolar_attention_pooled.py is the POOLING entry.
With `depth="rank"` it returns, in place of the (N, K', H, W) stack, the
(N, 1, H, W) ranking value of each query's best sample: what the JAX
streaming path (epipolar_transformers_tpu/ops/
epipolar_attention_streaming.py) returns as `depth` when nothing reads the
stack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import denormalize_pixel
from .quad_gather import corner_data

NEG_INF = -1e10  # reference epipolar.py:298
COS_EPS = 1e-8  # torch F.cosine_similarity default eps
# floor of a bilinear sample's squared norm: sqrt'(0) would NaN the backward
NORM2_FLOOR = 1e-24


class AttentionParams(NamedTuple):
    """Static attention configuration (subset of EPIPOLAR.*)."""

    attention: str = "avg"  # 'avg' | 'max'
    similarity: str = "dot"  # 'dot' | 'cos' | 'prior'
    softmax_enabled: bool = True
    softmax_scale: float = 0.125  # 1/sqrt(K)
    pooling: bool = False
    priormul: bool = False
    correct_normalize: bool = True


def supports_matmul_attention(params: AttentionParams) -> bool:
    """The configs the JAX matmul path expresses (epipolar_transformers_tpu/
    ops/epipolar_attention_matmul.py:57): all but POOLING."""
    return (params.attention in ("avg", "max")
            and params.similarity in ("dot", "cos", "prior") and not params.pooling)


def epipolar_similarity_weights(sim: torch.Tensor, params: AttentionParams,
                                prior: torch.Tensor | None = None, dim: int = 1) -> torch.Tensor:
    """Similarities -> attention weights along `dim` (the K axis).

    Reference epipolar_similarity, epipolar.py:287-321: an exact-zero
    similarity (an out-of-image sample) is masked to -1e10; the additive
    prior goes before the softmax unless PRIORMUL; softmax(scale * .) or
    . / K.  The additive prior under the softmax is the explicitly masked
    softmax of the JAX package: over the valid (sim != 0) slots only, a
    constant 1/K on a row without one, whatever the prior's size.
    """
    K = sim.shape[dim]
    masked = torch.where(sim == 0.0, NEG_INF, sim)
    if prior is not None and not params.priormul:
        if params.softmax_enabled:
            valid = sim != 0.0
            z = (sim + prior) * params.softmax_scale
            zmax = torch.where(valid, z, float("-inf")).amax(dim, keepdim=True)
            # min(., 0) keeps the discarded invalid lanes finite
            e = torch.where(valid, torch.exp(torch.clamp(z - zmax, max=0.0)), 0.0)
            s = e.sum(dim, keepdim=True)
            return torch.where(s > 0, e / torch.where(s > 0, s, 1.0), 1.0 / K)
        return (masked + prior) / K
    if params.softmax_enabled:
        w = torch.softmax(masked * params.softmax_scale, dim=dim)
        if prior is not None and params.priormul:
            w = w * prior
        return w
    return masked / K


def sample_stack(image: torch.Tensor, locs: torch.Tensor, H: int, W: int,
                 pooling: bool) -> torch.Tensor:
    """Bilinear samples of images (N, H*W, C) at locations (N, K, H*W, 2),
    in f32 (f64 for f64 images): (N, K, H*W, C), or with pooling
    (N, K/2, H*W, C), the pairs (k, k + K/2) max-reduced (reference
    epipolar.py:200-203).

    A corner of zero weight reads its query's own row.  `corner_data`
    clamps it to the image's corner, the same row for every sample of a
    line that misses the image, and the gather's backward (`index_put`
    with accumulate) adds all of those into that one row in turn: on the
    param recipe's H36M crops that one run set the step's time."""
    rows, wc = corner_data(locs, H, W)
    own = torch.arange(locs.shape[2], device=rows.device)[:, None]
    rows = torch.where(wc != 0, rows, own)
    items = torch.arange(image.shape[0], device=image.device)[:, None, None]
    image = image.to(_compute(image))
    out = None
    for c in range(4):
        v = image[items, rows[..., c]] * wc[..., c, None]
        out = v if out is None else out + v
    if pooling:
        half = locs.shape[1] // 2
        out = torch.maximum(out[:, :half], out[:, half:])
    return out


def _compute(t: torch.Tensor) -> torch.dtype:
    """The plain path computes in f32, or in f64 for f64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def _cosine(f1: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Cosine of queries (N, P, C) with samples (N, K, P, C) -> (N, K, P)."""
    dot = torch.einsum("npc,nkpc->nkp", f1, samples)
    n1 = torch.linalg.vector_norm(f1, dim=-1)
    n2 = torch.sqrt(torch.clamp((samples * samples).sum(-1), min=NORM2_FLOOR))
    return dot / (torch.clamp(n1, min=COS_EPS)[:, None] * torch.clamp(n2, min=COS_EPS))


def streaming_rank(sim: torch.Tensor, params: AttentionParams,
                   prior: torch.Tensor | None = None) -> torch.Tensor:
    """(N, K', P) similarities -> (N, 1, P): the JAX streaming path's
    `best_rank`, the ranking value of each query's best sample (max
    attention: its cosine; softmax: its logit, plus log p under PRIORMUL;
    softmax off: its weight)."""
    if params.attention == "max":
        return sim.amax(1, keepdim=True)
    masked = torch.where(sim == 0.0, NEG_INF, sim)
    if prior is not None and not params.priormul:
        masked = masked + prior
    if params.softmax_enabled:
        rank = masked * params.softmax_scale
        if prior is not None and params.priormul:
            rank = rank + torch.log(torch.clamp(prior, min=1e-30))
    else:
        rank = masked / sim.shape[1]
    return rank.amax(1, keepdim=True)


def epipolar_attention(feat1, other1, other2, sample_locs, params: AttentionParams,
                       prior=None, shared_kv: bool = False, depth: str = "weights"):
    """Batched epipolar attention in plain PyTorch.

    Args:
        feat1: (N, H, W, C) reference-view queries.
        other1: (N, H, W, Ck) source-view keys.
        other2: (N, H, W, Cv) source-view values.
        sample_locs: (N, K, H, W, 2) normalized sample locations.
        params: the attention config.
        prior: optional (N, K', H, W) per-pair prior (K' = K/2 under pooling).
        shared_kv: keys and values are one tensor: sample it once.
        depth: 'weights' for the (N, K', H, W) stack, 'rank' for the
            streaming path's (N, 1, H, W) placeholder.
    Returns:
        out (N, H, W, Cv) in other2's dtype; corr_pos (N, H, W, 2), the
        feature-pixel position of each query's best sample (under pooling
        the pair's first member); depth: the weights (avg) or the cosine
        stack (max), or the rank.
    """
    N, H, W, _ = feat1.shape
    K = sample_locs.shape[1]
    P = H * W
    locs = sample_locs.detach().reshape(N, K, P, 2).float()
    f1 = feat1.reshape(N, P, -1)
    f1 = f1.to(_compute(f1))
    keys = sample_stack(other1.reshape(N, P, -1), locs, H, W, params.pooling)
    Keff = keys.shape[1]
    prior_flat = None if prior is None else prior.reshape(N, Keff, P).to(keys.dtype)

    if params.attention == "max":
        # reference epipolar.py:282-286: max attention always uses cosine
        sim = _cosine(f1, keys)
        idx = sim.argmax(1)
        weights = torch.nn.functional.one_hot(idx, Keff).permute(0, 2, 1).to(sim.dtype)
        stack = sim
    elif params.attention == "avg":
        if params.similarity == "prior":
            if prior_flat is None:
                raise ValueError("similarity 'prior' needs a prior")
            weights = sim = prior_flat
        else:
            if params.similarity == "cos":
                sim = _cosine(f1, keys)
            elif params.similarity == "dot":
                sim = torch.einsum("npc,nkpc->nkp", f1, keys)
            else:
                raise NotImplementedError(params.similarity)
            weights = epipolar_similarity_weights(sim, params, prior_flat, dim=1)
        # reference takes the argmax of the final weights (epipolar.py:237-242)
        idx = weights.argmax(1)
        stack = weights
    else:
        raise NotImplementedError(params.attention)

    pos = torch.gather(locs[:, :Keff], 1, idx[:, None, :, None].expand(N, 1, P, 2))[:, 0]
    corr_pos = denormalize_pixel(pos.reshape(N, H, W, 2), H, W,
                                 correct=params.correct_normalize).detach()
    values = keys if shared_kv or other2 is other1 else \
        sample_stack(other2.reshape(N, P, -1), locs, H, W, params.pooling)
    out = torch.einsum("nkp,nkpc->npc", weights.to(values.dtype), values)
    out = out.reshape(N, H, W, -1).to(other2.dtype)
    if depth == "rank":
        stack = streaming_rank(sim, params, prior_flat)
    return out, corr_pos, stack.reshape(N, -1, H, W)
