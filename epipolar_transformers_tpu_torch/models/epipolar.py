"""Epipolar transformer layer (PyTorch, NCHW).

Port of epipolar_transformers_tpu/models/epipolar.py (reference
modeling/layers/epipolar.py:11-269) for the configs the fused attention
kernel covers: for every reference-view pixel, attend over SAMPLESIZE
points along its epipolar line in the other view, fuse the weighted source
features, then project through the 1x1 conv `z` + zero-init BN and
optionally add residually.

Sample locations come from ops/epipolar_sampling.py in float32, without
gradient; the attention is ops/epipolar_attention_cuda.py (the CUDA kernels
on the card, forward and backward, its plain twin under autograd on the
CPU).  On the card the features are channels_last, so their (N, H, W, C)
views, which the kernels read, need no copy.

Training (counterpart of the JAX layer with train=True): gradients reach
the query features, and the key and value features as EPIPOLAR.OTHER_GRAD
says.  ATTENTION_IMPL 'pallas' is forward-only in the JAX package and raises
under training here too; 'auto' trains through the kernels.  ATTENTION_REMAT
'full', 'dots' and 'none' are accepted and identical: the kernel backward
keeps only its inputs and recomputes the rest, which is what 'full' asks
for.  'dots_bf16' raises (it would change forward values under f32).

Not yet ported: the learned per-pair prior table (ROADMAP A10) and the other
attention configs (cos/max, pooling, FIND_CORR='rgb', theta/phi/g;
ROADMAP A10).  Each raises.
"""

from __future__ import annotations

from torch import nn

from epipolar_transformers_tpu.config import Config

from ..ops.epipolar_attention import AttentionParams
from ..ops.epipolar_attention_cuda import epipolar_attention_batch, supports_fused_attention
from ..ops.epipolar_sampling import EpipolarGeometry, epipolar_sample_locs
from .layers import Conv2d, ZeroInitBatchNorm, bn_momentum, compute_dtype


class Epipolar(nn.Module):
    # the attention function; chip_smoke.py swaps in the plain version on
    # one instance to compare the two on the same weights
    attention = staticmethod(epipolar_attention_batch)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.EPIPOLAR
        impl = e.ATTENTION_IMPL
        if impl not in ("auto", "pallas"):
            raise NotImplementedError(
                f"EPIPOLAR.ATTENTION_IMPL={impl!r}: the port has the fused kernel "
                "only ('auto' or 'pallas'); the other paths are ROADMAP A10")
        if not supports_fused_attention(self.attention_params):
            raise NotImplementedError(
                f"attention config {self.attention_params} is ROADMAP A10 "
                "(the port covers avg attention with dot or prior similarity)")
        unported = [k for k in ("theta", "phi", "g") if k in e.PARAMETERIZED]
        if unported or e.FIND_CORR == "rgb" or e.BOTTLENECK != 1:
            raise NotImplementedError(
                f"EPIPOLAR PARAMETERIZED={e.PARAMETERIZED} FIND_CORR={e.FIND_CORR!r} "
                f"BOTTLENECK={e.BOTTLENECK}: only 'z' over features is ported; "
                "the rest is ROADMAP A10")
        if e.PRIOR or e.SIMILARITY == "prior":
            raise NotImplementedError(
                "the learned EPIPOLAR.PRIOR table is ROADMAP A10 (the kernel "
                "itself takes priors)")
        if "z" in e.PARAMETERIZED:
            nfeats = cfg.KEYPOINT.NFEATS
            self.z = Conv2d(nfeats, nfeats, 1, bias=True, dtype=compute_dtype(cfg))
            self.bn = ZeroInitBatchNorm(nfeats, momentum=bn_momentum(cfg))

    def _check_trainable(self) -> None:
        """Refuse, as the JAX layer does, what has no training path."""
        e = self.cfg.EPIPOLAR
        if e.ATTENTION_IMPL == "pallas":
            raise ValueError(
                "EPIPOLAR.ATTENTION_IMPL='pallas' is forward-only in the JAX package "
                "(models/epipolar.py:250); train with 'auto', which runs the CUDA "
                "kernel backward")
        if e.ATTENTION_REMAT == "dots_bf16":
            raise NotImplementedError(
                "EPIPOLAR.ATTENTION_REMAT='dots_bf16' changes forward values under "
                "f32 (ROADMAP C-traps); use 'full', 'dots' or 'none'")
        if e.ATTENTION_REMAT not in ("full", "dots", "none"):
            raise ValueError(f"EPIPOLAR.ATTENTION_REMAT={e.ATTENTION_REMAT!r}: "
                             "expected 'full' | 'dots' | 'dots_bf16' | 'none'")

    @property
    def geometry(self) -> EpipolarGeometry:
        c = self.cfg
        h, w = c.KEYPOINT.HEATMAP_SIZE
        return EpipolarGeometry(
            feat_h=h,
            feat_w=w,
            sample_size=c.EPIPOLAR.SAMPLESIZE,
            downsample=c.BACKBONE.DOWNSAMPLE,
            resize=c.DATASETS.IMAGE_RESIZE * c.DATASETS.PREDICT_RESIZE,
            correct_normalize=c.EPIPOLAR.USE_CORRECT_NORMALIZE,
        )

    @property
    def attention_params(self) -> AttentionParams:
        e = self.cfg.EPIPOLAR
        return AttentionParams(
            attention=e.ATTENTION,
            similarity=e.SIMILARITY,
            softmax_enabled=e.SOFTMAX_ENABLED,
            softmax_scale=e.SOFTMAXSCALE,
            pooling=e.POOLING,
            priormul=e.PRIORMUL,
            correct_normalize=e.USE_CORRECT_NORMALIZE,
        )

    def forward(self, feat1, feat2, P1, P2):
        """
        Args:
            feat1: (N, C, H, W) reference-view features.
            feat2: (N, C, H, W) source-view features.
            P1, P2: (N, 3, 4) full-res projection matrices (KRT).
        Returns:
            (fused (N, C, H, W), corr_pos (N, H, W, 2), depth (N, K, H, W),
             sample_locs (N, K, H, W, 2))
        """
        e = self.cfg.EPIPOLAR
        if self.training:
            self._check_trainable()
        # key/value selection + detach semantics (reference epipolar.py:134-157)
        other1 = feat2 if "other1" in e.OTHER_GRAD else feat2.detach()
        other2 = feat2 if "other2" in e.OTHER_GRAD else feat2.detach()

        # geometry, in float32 even under bfloat16 compute
        sample_locs = epipolar_sample_locs(P1, P2, self.geometry).detach()

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        out, corr_pos, depth = self.attention(
            nhwc(feat1), nhwc(other1), nhwc(other2), sample_locs, self.attention_params)
        out = out.permute(0, 3, 1, 2)

        # z projection + zero-init BN (+ residual)   epipolar.py:249-255
        if "z" in e.PARAMETERIZED:
            finalout = self.bn(self.z(out))
            if e.ZRESIDUAL:
                finalout = finalout + out
        else:
            finalout = out
        return finalout, corr_pos.detach(), depth, sample_locs
