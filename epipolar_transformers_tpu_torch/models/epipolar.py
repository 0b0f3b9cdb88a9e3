"""Epipolar transformer layer (PyTorch, NCHW).

Port of epipolar_transformers_tpu/models/epipolar.py (reference
modeling/layers/epipolar.py:11-269): for every reference-view pixel,
attend over SAMPLESIZE points along its epipolar line in the other view,
fuse the weighted source features, then project through the 1x1 conv `z`
+ zero-init BN and optionally add residually.  PARAMETERIZED theta, phi
and g are 1x1 convs to NFEATS // BOTTLENECK channels on the queries, keys
and values; FIND_CORR 'rgb' matches the downsampled images instead of the
features; PRIOR adds a learned (pairs, K', H, W) table over the ordered
pairs of DATASETS.CAMERAS (K' = K/2 under POOLING), read through a
(id, id) -> slot lookup whose -1 guard gives an unlisted or out-of-range
pair a zero prior.

Sample locations come from ops/epipolar_sampling.py in float32, without
gradient.  The attention route is decided from the config when the layer
is built (`route`), as EPIPOLAR.ATTENTION_IMPL asks:
  * 'kernel': ops/epipolar_attention_cuda.py, the CUDA kernels on the card
    (forward and backward, the prior's gradient included), their plain
    twin under autograd on the CPU.  'pallas' always; 'auto' and 'matmul'
    where the kernel covers the config (avg attention, dot or prior
    similarity, no POOLING) and its widths (queries, keys and values of
    one width in 32/64/128/256; FIND_CORR 'rgb' has 3).
  * 'plain': ops/epipolar_attention.py, every other config under 'auto'
    and 'matmul' (cos/max, the widths above), and 'reference'.
  * 'pooled': ops/epipolar_attention_pooled.py under 'pooled'.
  * 'streaming': 'auto' with POOLING, and 'streaming': the plain path,
    whose `depth` is the JAX streaming path's (N, 1, H, W) best-rank
    placeholder unless a consumer reads the stack (the reprojection loss,
    WARPEDHEATMAP, VIS.EPIPOLAR_LINE, SAVE_PRED at eval).  Under 'auto',
    where the pooled kernels cover the config (`pooled_kernel`: avg
    attention, dot similarity, the softmax on, no PRIOR, K <= 64, queries,
    keys and values 128 wide), the route runs them instead:
    ops/epipolar_attention_pooled_cuda.py, the CUDA kernels on the card and
    the same plain path on the CPU, with the same `depth`.
With POOLING the attention runs in the `epipolar.pooled_attention` span,
between the device marks `epipolar_pooled_*` (ops/trace_marks.py: forward
and backward, so that a replayed CUDA graph shows the interval in the
device trace), and adds its bilinear samples to `attn.pooled_samples`
(ops/epipolar_attention_pooled.py:count_samples).
An impl that cannot express the config raises where the JAX layer raises
(`ValueError`), 'pallas' under training too.  On the card the features
are channels_last, so the (N, H, W, C) views the kernels read need no
copy.

Training: gradients reach the queries, the keys and values as
EPIPOLAR.OTHER_GRAD says, theta/phi/g/z and the prior table, whose
gradient sums the items in a fixed order (two runs are bit-equal).
ATTENTION_REMAT 'full', 'dots' and 'none' are one function here: the
kernel backward keeps only its inputs; 'dots_bf16' raises (it would
change forward values under f32).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ops.epipolar_attention import (AttentionParams, epipolar_attention,
                                      supports_matmul_attention)
from ..ops.epipolar_attention_cuda import (KERNEL_CHANNELS, epipolar_attention_batch,
                                           supports_fused_attention)
from ..ops import trace_marks
from ..ops.epipolar_attention_pooled import (count_samples, epipolar_attention_pooled,
                                             supports_pooled_attention)
from ..ops.epipolar_attention_pooled_cuda import (epipolar_attention_pooled_kernel, kernel_shape,
                                                  supports_pooled_kernel)
from ..ops.epipolar_sampling import EpipolarGeometry, epipolar_sample_locs
from ..utils import tracing
from .layers import Conv2d, ZeroInitBatchNorm, bn_momentum, compute_dtype

IMPLS = ("auto", "pallas", "matmul", "pooled", "streaming", "reference")


class _PairPrior(torch.autograd.Function):
    """table (P, K', H, W), slot (N,) with -1 for no pair -> (N, K', H, W),
    zero where slot is -1.  The backward sums each pair's items in item
    order (a reduction, no atomics), so two runs give the same bits."""

    @staticmethod
    def forward(ctx, table, slot):
        ctx.save_for_backward(slot)
        ctx.pairs = table.shape[0]
        gathered = table[slot.clamp(min=0)]
        # contiguous: a channels_last model keeps its 4-D table so, and the
        # kernels read the prior in (N, K', H, W) order
        return torch.where((slot >= 0)[:, None, None, None], gathered, 0.0).contiguous()

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        pairs = torch.arange(ctx.pairs, device=slot.device)
        onehot = (slot[None, :] == pairs[:, None]).to(grad.dtype)  # (P, N)
        dtable = (onehot[:, :, None] * grad.reshape(1, grad.shape[0], -1)).sum(1)
        return dtable.reshape((ctx.pairs,) + grad.shape[1:]), None


class Epipolar(nn.Module):
    # the attention function of the kernel route; chip_smoke.py swaps in
    # the plain version on one instance to compare the two on the same
    # weights
    attention = staticmethod(epipolar_attention_batch)

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        e = cfg.EPIPOLAR
        nfeats = cfg.KEYPOINT.NFEATS
        bottleneck = nfeats // e.BOTTLENECK
        if e.BOTTLENECK != 1 and (
                not all(k in e.PARAMETERIZED for k in ("z", "theta", "phi", "g")) or e.ZRESIDUAL):
            # reference epipolar.py:56-61 (asserts in the JAX layer)
            raise ValueError(f"EPIPOLAR.BOTTLENECK={e.BOTTLENECK} needs PARAMETERIZED z, theta, "
                             "phi and g, and ZRESIDUAL False")
        rgb = e.FIND_CORR == "rgb"
        if rgb and ("other1" in e.OTHER_GRAD or "phi" in e.PARAMETERIZED):
            raise ValueError("EPIPOLAR.FIND_CORR='rgb' takes no 'other1' in OTHER_GRAD and no "
                             "'phi' in PARAMETERIZED")
        d = compute_dtype(cfg)
        if "theta" in e.PARAMETERIZED and not rgb:
            self.theta = Conv2d(nfeats, bottleneck, 1, bias=True, dtype=d)
        if "phi" in e.PARAMETERIZED:
            self.phi = Conv2d(nfeats, bottleneck, 1, bias=True, dtype=d)
        if "g" in e.PARAMETERIZED:
            self.g = Conv2d(nfeats, bottleneck, 1, bias=True, dtype=d)
        value_width = bottleneck if "g" in e.PARAMETERIZED else nfeats
        if "z" in e.PARAMETERIZED:
            self.z = Conv2d(value_width, nfeats, 1, bias=True, dtype=d)
            self.bn = ZeroInitBatchNorm(nfeats, momentum=bn_momentum(cfg))
        if e.SIMILARITY == "prior" and not e.PRIOR:
            raise ValueError("EPIPOLAR.SIMILARITY='prior' reads the learned table: set "
                             "EPIPOLAR.PRIOR")
        if e.PRIOR:
            cams = tuple(cfg.DATASETS.CAMERAS)
            if not cams:
                raise ValueError("EPIPOLAR.PRIOR requires DATASETS.CAMERAS to list the camera "
                                 "ids (reference epipolar.py:74-80)")
            pairs = [(i, j) for i in cams for j in cams if i != j]
            # the -1 guard row and column absorb ids above max(cams)
            lookup = torch.full((max(cams) + 2, max(cams) + 2), -1, dtype=torch.int64)
            for slot, (i, j) in enumerate(pairs):
                lookup[i, j] = slot
            self.register_buffer("prior_pair_lookup", lookup, persistent=False)
            h, w = cfg.KEYPOINT.HEATMAP_SIZE
            k = e.SAMPLESIZE // (2 if e.POOLING else 1)
            self.prior = nn.Parameter(torch.empty(max(len(pairs), 1), k, h, w))
            nn.init.uniform_(self.prior, 0.0, 0.1)
        query_width = 3 if rgb else bottleneck if "theta" in e.PARAMETERIZED else nfeats
        key_width = 3 if rgb else bottleneck if "phi" in e.PARAMETERIZED else nfeats
        self.shared_kv = (not rgb and "phi" not in e.PARAMETERIZED and "g" not in e.PARAMETERIZED
                          and ("other1" in e.OTHER_GRAD) == ("other2" in e.OTHER_GRAD))
        self.route = self._route({query_width, key_width, value_width})
        self.pooled_kernel = (e.ATTENTION_IMPL == "auto" and self.route == "streaming"
                              and not e.PRIOR
                              and supports_pooled_kernel(self.attention_params)
                              and kernel_shape(e.SAMPLESIZE, (query_width, key_width,
                                                              value_width)))

    def _route(self, widths) -> str:
        """The attention route of this config (the module docstring)."""
        e = self.cfg.EPIPOLAR
        impl, params = e.ATTENTION_IMPL, self.attention_params
        if impl not in IMPLS:
            raise ValueError(f"unknown EPIPOLAR.ATTENTION_IMPL {impl!r}")
        if ((impl == "matmul" and not supports_matmul_attention(params))
                or (impl == "pallas" and not supports_fused_attention(params))
                or (impl == "pooled" and not supports_pooled_attention(params))
                or (impl == "streaming" and e.SIMILARITY == "prior")):
            raise ValueError(f"EPIPOLAR.ATTENTION_IMPL={impl!r} does not support this config's "
                             f"attention semantics ({params}); use 'auto'")
        kernel_widths = len(widths) == 1 and widths <= set(KERNEL_CHANNELS)
        if impl == "pallas" or (impl in ("auto", "matmul") and supports_fused_attention(params)
                                and kernel_widths):
            return "kernel"
        if impl in ("auto", "matmul") and supports_matmul_attention(params):
            return "plain"
        if impl == "pooled":
            return "pooled"
        if impl in ("auto", "streaming") and e.SIMILARITY != "prior":
            return "streaming"
        return "plain"

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The prior table's U[0, 0.1) start (JAX models/epipolar.py:170-174),
        from `generator`; the convolutions are the backbone's to draw."""
        if hasattr(self, "prior"):
            self.prior.copy_(torch.rand(self.prior.shape, generator=generator) * 0.1)

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

    def pair_prior(self, camera, other_camera):
        """(N, K', H, W) prior of each item's (camera, other_camera) pair: an
        id is wrapped and clamped into the lookup as JAX indexes, and a pair
        without parameters (slot -1) reads zero."""
        lookup = self.prior_pair_lookup
        size = lookup.shape[0]

        def index(ids):
            ids = ids.to(device=lookup.device, dtype=torch.int64).reshape(-1)
            return torch.where(ids < 0, ids + size, ids).clamp(0, size - 1)

        return _PairPrior.apply(self.prior, lookup[index(camera), index(other_camera)])

    def _need_depth(self) -> bool:
        """Whether a consumer reads the full weight stack (JAX models/epipolar.py:341-346)."""
        c = self.cfg
        e = c.EPIPOLAR
        return (e.REPROJECT_LOSS_WEIGHT != 0 or e.WARPEDHEATMAP or c.VIS.EPIPOLAR_LINE
                or (not self.training and c.VIS.SAVE_PRED))

    def attend(self, q, k, v, sample_locs, prior=None):
        """The attention on this layer's route: (N, H, W, C) queries, keys
        and values and (N, K, H, W, 2) sample locations -> out (N, H, W,
        C'), corr_pos, depth.  utils/profiling.py counts its FLOPs by
        formula, whatever route computes it."""
        params = self.attention_params
        if self.route == "kernel":
            return self.attention(q, k, v, sample_locs, params, prior)
        if params.pooling:
            return self._pooled(q, k, v, sample_locs, prior)
        return self._plain(q, k, v, sample_locs, prior)

    def _plain(self, q, k, v, sample_locs, prior):
        """The attention without the POOLING routes' span, marks and count:
        the plain paths, or the pooled kernels where `pooled_kernel`."""
        params = self.attention_params
        if self.route == "pooled":
            return epipolar_attention_pooled(q, k, v, sample_locs, params, prior,
                                             shared_kv=self.shared_kv)
        depth_kind = ("rank" if self.route == "streaming" and not self._need_depth()
                      else "weights")
        if self.route == "streaming" and self.pooled_kernel:
            return epipolar_attention_pooled_kernel(q, k, v, sample_locs, params,
                                                    shared_kv=self.shared_kv, depth=depth_kind)
        return epipolar_attention(q, k, v, sample_locs, params, prior,
                                  shared_kv=self.shared_kv, depth=depth_kind)

    def _pooled(self, q, k, v, sample_locs, prior):
        """The POOLING routes ('pooled', 'streaming'), bracketed and counted
        (the module docstring)."""
        with tracing.span("epipolar.pooled_attention"):
            shared = v is k or self.shared_kv
            N, K, H, W, _ = sample_locs.shape
            count_samples(q.device, N * K * H * W * (1 if shared else 2))
            q, k, *rest = trace_marks.enter("epipolar_pooled", q, k, *(() if v is k else (v,)))
            out, corr_pos, depth = self._plain(q, k, rest[0] if rest else k, sample_locs, prior)
            (out,) = trace_marks.leave("epipolar_pooled", out)
            return out, corr_pos, depth

    def forward(self, feat1, feat2, P1, P2, camera=None, other_camera=None, ref1=None, ref2=None):
        """
        Args:
            feat1: (N, C, H, W) reference-view features.
            feat2: (N, C, H, W) source-view features.
            P1, P2: (N, 3, 4) full-res projection matrices (KRT).
            camera/other_camera: (N,) camera ids (the learned prior).
            ref1/ref2: (N, 3, H, W) downsampled images (FIND_CORR 'rgb').
        Returns:
            (fused (N, C, H, W), corr_pos (N, H, W, 2), depth (N, K', H, W)
             or the (N, 1, H, W) placeholder, sample_locs (N, K, H, W, 2))
        Runs in the `epipolar.fusion` span (utils/tracing.py).
        """
        with tracing.span("epipolar.fusion"):
            e = self.cfg.EPIPOLAR
            if self.training:
                self._check_trainable()
            # key/value selection + detach semantics (reference epipolar.py:134-157)
            if e.FIND_CORR == "rgb":
                if ref1 is None or ref2 is None:
                    raise ValueError("EPIPOLAR.FIND_CORR='rgb' needs the downsampled images")
                keys, query = ref2.detach(), ref1
            else:
                keys = feat2 if "other1" in e.OTHER_GRAD else feat2.detach()
                if hasattr(self, "phi"):
                    keys = self.phi(keys)
                query = self.theta(feat1) if hasattr(self, "theta") else feat1
            values = feat2 if "other2" in e.OTHER_GRAD else feat2.detach()
            if hasattr(self, "g"):
                values = self.g(values)
            if self.shared_kv:
                # one object: the kernel backward sums both gradients into one buffer
                values = keys

            # geometry, in float32 even under bfloat16 compute
            sample_locs = epipolar_sample_locs(P1, P2, self.geometry).detach()
            prior = None
            if e.PRIOR:
                if camera is None or other_camera is None:
                    raise ValueError("EPIPOLAR.PRIOR needs the camera and other_camera ids")
                prior = self.pair_prior(camera, other_camera)

            def nhwc(t):
                return t.permute(0, 2, 3, 1)

            q, k = nhwc(query), nhwc(keys)
            v = k if values is keys else nhwc(values)
            out, corr_pos, depth = self.attend(q, k, v, sample_locs, prior)
            out = out.permute(0, 3, 1, 2)

            # z projection + zero-init BN (+ residual)   epipolar.py:249-255
            if hasattr(self, "z"):
                finalout = self.bn(self.z(out))
                if e.ZRESIDUAL:
                    finalout = finalout + out
            else:
                finalout = out
            return finalout, corr_pos.detach(), depth, sample_locs
