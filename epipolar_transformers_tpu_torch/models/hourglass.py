"""Stacked hourglass backbone (PyTorch, NCHW) with per-stack multiview fusion.

Port of epipolar_transformers_tpu/models/hourglass.py (reference
modeling/backbones/ProHG.py:18-307): pre-activation `Residual` and
`HierarchicalPMS` modules; the recursive `Hourglass` (max-pool down,
bilinear align_corners up); `HourglassNet` with its stem, nStack stages,
intermediate supervision (`trsfea`/`trstmp`) and the per-stack fusion:
'epipolar' (the shared `Epipolar` layer, models/epipolar.py), 'meta' (the
hypernetwork, models/meta.py), 'simple' (a plain add) or none, merged
'late', 'early', 'both' or 'none'.  `features` is a tuple with one map per
merge point: what a sibling net hands to the multiview net's fusion, from
`trunk_features` (the stacks with no fusion and without the last stack's
head, which no feature reads), as a PoseResNet's.  `final_layer` is the
last stack's head, `tmpOut{n_stack - 1}`, under the PoseResNet's name.
SOLVER.FINETUNE stops the gradient at the fusion boundary, and
EPIPOLAR.OTHER_ONLY keeps the fused map without the residual add.

Tracing (utils/tracing.py, ops/trace_marks.py): the stem runs in the
`hourglass.stem` span and each stack in an `hourglass.stack` span; each
merge point's whole fusion (the attention, `z` and BN, the residual adds)
runs between the device marks `hourglass_fusion_*`, forward and backward,
so that a replayed CUDA graph shows each fusion's interval in the device
trace.

Child names are the flax module names (`stem_conv0`, `ress0`,
`hg0.res0.bnA`, `tower0_mod0`, `tmpOut0`, `epipolar_sampler`, `meta0`, ...),
so utils/jax_import.py maps them.  The convolutions compute in float32 and
carry biases, as flax's `nn.Conv` there; `init_weights` draws flax's
initializers (LeCun truncated normal kernels, zero biases, unit BN) from an
explicit generator.

EPIPOLAR.FIND_CORR 'rgb' matches the images, average-pooled by
BACKBONE.DOWNSAMPLE and detached, instead of the features (JAX
models/hourglass.py:221-231); it needs `other_img`.  EPIPOLAR.WARPEDHEATMAP
warps `other_heatmaps`, when given, along each pixel's epipolar line to the
sample of highest attention weight (`_warp_heatmaps`, JAX :303-304,
324-345) into `warped_heatmap`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from ..ops import trace_marks
from ..ops.epipolar_sampling import epipolar_sample_locs
from ..ops.grid_sample import grid_sample_nhwc
from ..ops.resize import resize_bilinear_align_corners
from ..ops.soft_argmax import find_tensor_peak_batch
from ..utils import tracing
from .epipolar import Epipolar
from .layers import BatchNorm2d, Conv2d, ZeroInitBatchNorm, bn_momentum
from .meta import Meta
from .resnet import BackboneOutput, _truncated_normal_

HG_CONFIGS = {
    # reference ProHG.py:310-395
    "HG": dict(stages=3, n_modules=1, recursive=3),
    "HG1": dict(stages=1, n_modules=1, recursive=3),
    "HG11": dict(stages=1, n_modules=1, recursive=1),
}
HG_BODIES = ("HG", "HG1", "HG11", "epipolarHG", "epipolarHG1", "epipolarHG11", "metaHG",
             "simplemultiviewHG")


def _bn(cfg, planes):
    return BatchNorm2d(planes, eps=1e-5, momentum=bn_momentum(cfg))


class Residual(nn.Module):
    """Pre-activation bottleneck residual (ProHG.py:18-50)."""

    def __init__(self, cfg: Config, num_in: int, num_out: int):
        super().__init__()
        middle = num_out // 2
        self.bnA = _bn(cfg, num_in)
        self.convA = Conv2d(num_in, middle, 1)
        self.bnB = _bn(cfg, middle)
        self.convB = Conv2d(middle, middle, 3, padding=1)
        self.bnC = _bn(cfg, middle)
        self.convC = Conv2d(middle, num_out, 1)
        if num_in != num_out:
            self.bnR = _bn(cfg, num_in)
            self.branch = Conv2d(num_in, num_out, 1)

    def forward(self, x):
        h = self.convA(torch.relu(self.bnA(x)))
        h = self.convB(torch.relu(self.bnB(h)))
        h = self.convC(torch.relu(self.bnC(h)))
        r = self.branch(torch.relu(self.bnR(x))) if hasattr(self, "branch") else x
        return h + r


class HierarchicalPMS(nn.Module):
    """Hierarchical parallel-multi-scale module (ProHG.py:53-87).  No body
    of the registry builds it (no config sets the JAX HourglassNet's
    `module`); tests/test_torch_hourglass.py holds it to the JAX module."""

    def __init__(self, cfg: Config, num_in: int, num_out: int):
        super().__init__()
        cA, cB = num_out // 2, num_out // 4
        cC = num_out - cA - cB
        self.bnA = _bn(cfg, num_in)
        self.convA = Conv2d(num_in, cA, 3, padding=1)
        self.bnB = _bn(cfg, cA)
        self.convB = Conv2d(cA, cB, 3, padding=1)
        self.bnC = _bn(cfg, cB)
        self.convC = Conv2d(cB, cC, 3, padding=1)
        if num_in != num_out:
            self.bnR = _bn(cfg, num_in)
            self.branch = Conv2d(num_in, num_out, 1)

    def forward(self, x):
        a = self.convA(torch.relu(self.bnA(x)))
        b = self.convB(torch.relu(self.bnB(a)))
        c = self.convC(torch.relu(self.bnC(b)))
        r = self.branch(torch.relu(self.bnR(x))) if hasattr(self, "branch") else x
        return torch.cat([a, b, c], dim=1) + r


class Hourglass(nn.Module):
    """Recursive hourglass (ProHG.py:91-119)."""

    def __init__(self, cfg: Config, n: int, n_modules: int, n_feats: int):
        super().__init__()
        self.n_modules = n_modules
        for i in range(n_modules):
            setattr(self, f"res{i}", Residual(cfg, n_feats, n_feats))
        self.pool = nn.MaxPool2d(2, 2)
        for i in range(n_modules):
            setattr(self, f"down{i}", Residual(cfg, n_feats, n_feats))
        if n > 1:
            self.mid = Hourglass(cfg, n - 1, n_modules, n_feats)
        else:
            for i in range(n_modules):
                setattr(self, f"mid{i}", Residual(cfg, n_feats, n_feats))
        for i in range(n_modules):
            setattr(self, f"up{i}", Residual(cfg, n_feats, n_feats))

    def _chain(self, name, x):
        for i in range(self.n_modules):
            x = getattr(self, f"{name}{i}")(x)
        return x

    def forward(self, x):
        res = self._chain("res", x)
        down = self._chain("down", self.pool(res))
        mid = self.mid(down) if hasattr(self, "mid") else self._chain("mid", down)
        up = self._chain("up", mid)
        return res + resize_bilinear_align_corners(up, res.shape[-2:])


class HourglassNet(nn.Module):
    """The hourglass family of models/registry.py, built of `Residual`
    modules (no body selects `HierarchicalPMS`).  `single_view` builds a
    sibling that only ever runs single-view: it holds no fusion layer, as
    its flax twin creates none (a setup module that is never called holds
    no parameters)."""

    def __init__(self, cfg: Config, single_view: bool = False):
        super().__init__()
        self.cfg = c = cfg
        body = c.BACKBONE.BODY
        v = next((HG_CONFIGS[s] for s in ("HG11", "HG1", "HG") if body.endswith(s)),
                 HG_CONFIGS["HG"])
        self.n_stack, self.n_modules = v["stages"], v["n_modules"]
        nf = self.n_feats = c.KEYPOINT.NFEATS
        self.fusion = ("epipolar" if "epipolarHG" in body else "meta" if "metaHG" in body
                       else "simple" if "simplemultiviewHG" in body else None)
        self.stem_conv0 = Conv2d(3, 32, 3, 2, 1)
        self.stem_bn0 = _bn(c, 32)
        self.stem_conv1 = Conv2d(32, 32, 3, 1, 1)
        self.stem_bn1 = _bn(c, 32)
        self.stem_conv2 = Conv2d(32, 64, 3, 1, 1)
        self.stem_bn2 = _bn(c, 64)
        self.ress0 = Residual(c, 64, 128)
        self.pool = nn.MaxPool2d(3, 2, 1)
        self.ress1 = Residual(c, 128, 128)
        self.ress2 = Residual(c, 128, nf)
        J = c.KEYPOINT.NUM_PTS
        for i in range(self.n_stack):
            setattr(self, f"hg{i}", Hourglass(c, v["recursive"], self.n_modules, nf))
            for m in range(self.n_modules):
                setattr(self, f"tower{i}_mod{m}", Residual(c, nf, nf))
            setattr(self, f"tower{i}_conv", Conv2d(nf, nf, 1))
            setattr(self, f"tower{i}_bn", _bn(c, nf))
            setattr(self, f"tmpOut{i}", Conv2d(nf, J, 1))
            if i < self.n_stack - 1:
                setattr(self, f"trsfea{i}", Conv2d(nf, nf, 1))
                setattr(self, f"trstmp{i}", Conv2d(J, nf, 1))
        # MERGE 'none' never fuses, so its flax twin holds no fusion layer
        fusion = not single_view and c.EPIPOLAR.MERGE != "none"
        if fusion and self.fusion == "epipolar":
            self.epipolar_sampler = Epipolar(c)
        elif fusion and self.fusion == "meta":
            for i in range(self.n_stack):
                setattr(self, f"meta{i}", Meta(nf))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's initializers (LeCun truncated normal kernels, zero biases,
        unit BN, zero for the zero-init BN), drawn from `generator` on the
        CPU in module order."""
        for m in self.modules():
            if isinstance(m, Epipolar):
                m.init_weights(generator)
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(0.0 if isinstance(m, ZeroInitBatchNorm) else 1.0)
                m.bias.zero_()
                m.reset_running_stats()
            elif isinstance(m, (Conv2d, nn.Linear)):
                _truncated_normal_(m.weight, 1.0, m.weight[0].numel(), generator)
                m.bias.zero_()

    @property
    def final_layer(self) -> Conv2d:
        """The last stack's head (`tmpOut{n_stack - 1}`), under the name a
        PoseResNet gives its head; not a child of its own, so it adds no
        key to the state_dict."""
        return getattr(self, f"tmpOut{self.n_stack - 1}")

    def _tower(self, i, z):
        z = getattr(self, f"hg{i}")(z)
        for m in range(self.n_modules):
            z = getattr(self, f"tower{i}_mod{m}")(z)
        return torch.relu(getattr(self, f"tower{i}_bn")(getattr(self, f"tower{i}_conv")(z)))

    def _fuse(self, idx, feat, other_features, KRT, other_KRT, ids, refs):
        """The idx-th merge point: (fused, corr_pos, depth, sample_locs),
        between the `hourglass_fusion` marks."""
        if other_features is None:
            return feat, None, None, None
        feat, other = trace_marks.enter("hourglass_fusion", feat, other_features[idx])
        cp = d = sl = None
        if self.fusion == "simple":
            ret = other
        elif self.fusion == "meta":
            ret = getattr(self, f"meta{idx}")(KRT, other_KRT, other)
        elif self.fusion == "epipolar":
            ret, cp, d, sl = self.epipolar_sampler(feat, other, KRT, other_KRT, *ids, *refs)
        else:
            raise NotImplementedError(self.cfg.BACKBONE.BODY)
        fused = ret if self.cfg.EPIPOLAR.OTHER_ONLY else ret + feat
        (fused,) = trace_marks.leave("hourglass_fusion", fused)
        return fused, cp, d, sl

    def trunk_features(self, x) -> tuple[torch.Tensor, ...]:
        """One view's features with no fusion, one map per merge point (a
        sibling's pass under the multiview net); the last stack's head is
        left out, as no feature reads it."""
        return tuple(self._stacks(x, lambda feat: feat, last_head=False)[1])

    def _stacks(self, x, fuse, last_head: bool = True):
        """The stem and the stacks on `x`, each merge point's map through
        `fuse`: (heatmaps, features), the last stack's head left out unless
        `last_head`."""
        c = self.cfg
        with tracing.span("hourglass.stem"):
            h = torch.relu(self.stem_bn0(self.stem_conv0(x)))
            h = torch.relu(self.stem_bn1(self.stem_conv1(h)))
            h = torch.relu(self.stem_bn2(self.stem_conv2(h)))
            h = self.ress2(self.ress1(self.pool(self.ress0(h))))

        def cut(t):
            return t.detach() if c.SOLVER.FINETUNE else t

        heatmaps, features = [], []
        merge = c.EPIPOLAR.MERGE
        for i in range(self.n_stack):
            with tracing.span("hourglass.stack"):
                # the features list mirrors the reference (ProHG.py:242-279):
                # early/none the stack input, late the fused tower output,
                # both the two
                if merge == "early":
                    feature = self._tower(i, cut(fuse(h)))
                    features.append(h)
                elif merge == "both":
                    fused = fuse(h)
                    features.append(h)
                    feature = fuse(self._tower(i, cut(fused)))
                    features.append(feature)
                elif merge == "late":
                    feature = fuse(cut(self._tower(i, h)))
                    features.append(feature)
                else:  # 'none'
                    feature = self._tower(i, h)
                    features.append(h)
                if i < self.n_stack - 1 or last_head:
                    hm = getattr(self, f"tmpOut{i}")(feature)
                    heatmaps.append(hm)
                if i < self.n_stack - 1:
                    h = h + getattr(self, f"trsfea{i}")(feature) + \
                        getattr(self, f"trstmp{i}")(hm)
        return heatmaps, features

    def forward(self, x, other_features=None, other_KRT=None, KRT=None, camera=None,
                other_camera=None, other_img=None, other_heatmaps=None,
                decode_peaks: bool = True) -> BackboneOutput:
        """
        Args:
            x: (N, 3, H, W) images.
            other_features: the sibling's `features`, one (N, C, h, w) map
                per merge point, or None for single-view.
            other_KRT / KRT: (N, 3, 4) projections.
            camera / other_camera: (N,) camera ids (EPIPOLAR.PRIOR).
            other_img: (N, 3, H, W) the other view's images (FIND_CORR 'rgb').
            other_heatmaps: (N, J, h, w) the other view's heatmaps to warp
                (WARPEDHEATMAP).
        """
        c = self.cfg
        refs = ()
        if other_features is not None and self.fusion == "epipolar" \
                and c.EPIPOLAR.FIND_CORR == "rgb":
            if other_img is None:
                raise ValueError("EPIPOLAR.FIND_CORR='rgb' needs other_img")
            ds = c.BACKBONE.DOWNSAMPLE
            refs = tuple(torch.nn.functional.avg_pool2d(t, ds, ds).detach()
                         for t in (x, other_img))
        corr_pos = depth = sample_locs = None
        n_fused = 0

        def fuse(feat):
            nonlocal n_fused, corr_pos, depth, sample_locs
            fused, corr_pos, depth, sample_locs = self._fuse(
                n_fused, feat, other_features, KRT, other_KRT, (camera, other_camera), refs)
            n_fused += 1
            return fused

        heatmaps, features = self._stacks(x, fuse)

        warped = None
        if c.EPIPOLAR.WARPEDHEATMAP and other_heatmaps is not None and depth is not None:
            warped = self._warp_heatmaps(other_heatmaps, KRT, other_KRT, depth)

        locs = scores = None
        if decode_peaks:
            locs, scores = find_tensor_peak_batch(heatmaps[-1].float(), c.KEYPOINT.SIGMA,
                                                  c.BACKBONE.DOWNSAMPLE)
        return BackboneOutput(
            features=tuple(features), heatmaps=tuple(heatmaps), locs=locs, scores=scores,
            corr_pos=corr_pos, depth=depth, sample_locs=sample_locs, warped_heatmap=warped,
        )

    def _warp_heatmaps(self, other_heatmaps, KRT, other_KRT, depth):
        """The other view's heatmaps (N, J, h, w) sampled along each pixel's
        epipolar line at the sample of highest attention weight (reference
        epipolar.py:470-514, the hard-max variant; sample 0 reads zero, as
        there at :502) -> (N, J, h, w)."""
        locs = epipolar_sample_locs(KRT, other_KRT, self.epipolar_sampler.geometry)
        samples = grid_sample_nhwc(other_heatmaps.permute(0, 2, 3, 1), locs)  # (N, K, h, w, J)
        samples = torch.cat([torch.zeros_like(samples[:, :1]), samples[:, 1:]], dim=1)
        idx = depth.argmax(1)[:, None, ..., None].expand(-1, 1, -1, -1, samples.shape[-1])
        return torch.gather(samples, 1, idx)[:, 0].permute(0, 3, 1, 2)
