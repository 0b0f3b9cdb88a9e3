"""Epipolar attention for sample-POOLING configs, in plain PyTorch.

Port of epipolar_transformers_tpu/ops/epipolar_attention_pooled.py
(reference modeling/layers/epipolar.py:200-213, configs/epipolar/
keypoint_h36m_param.yaml): the K sampled feature vectors are gathered at
once, the pairs (k, k + K/2) max-reduced,

    pooled[k] = max(bilinear(f2, loc_k), bilinear(f2, loc_{k+K/2}))   (k < K/2)

and the similarity, weights and fusion run as dense einsums in f32.  The
feature max is not linear in the source features, so neither the Gram form
nor the CUDA kernel applies; no TPU kernel exists for it either.  The
schedule is ops/epipolar_attention.py's, which this entry calls with
pooling on.  Peak memory is the (N, K, H, W, C) sample stack of the keys,
and of the values unless they are the keys.
"""

from __future__ import annotations

from .epipolar_attention import AttentionParams, epipolar_attention


def supports_pooled_attention(params: AttentionParams) -> bool:
    """POOLING with avg or max attention and dot or cos similarity (a
    'prior' similarity never samples the keys, so pooling would mean
    nothing; the reference has no such config)."""
    return (
        params.pooling
        and params.attention in ("avg", "max")
        and params.similarity in ("dot", "cos")
    )


def epipolar_attention_pooled(feat1, other1, other2, sample_locs, params: AttentionParams,
                              prior=None, shared_kv: bool = False, depth: str = "weights"):
    """Batched pooled attention; arguments and returns as
    `ops.epipolar_attention.epipolar_attention`, with prior and depth over
    the K/2 pooled slots and corr_pos at each best pair's first member."""
    if not supports_pooled_attention(params):
        raise ValueError(f"pooled attention takes POOLING with avg/max attention and "
                         f"dot/cos similarity, not {params}")
    return epipolar_attention(feat1, other1, other2, sample_locs, params, prior,
                              shared_kv=shared_kv, depth=depth)
