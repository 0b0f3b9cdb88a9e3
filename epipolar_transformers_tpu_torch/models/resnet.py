"""PoseResNet backbone (PyTorch, NCHW) with the late epipolar merge.

Port of epipolar_transformers_tpu/models/resnet.py (reference
modeling/backbones/resnet.py): ResNet-18..152 trunk (stride on the 3x3
conv of a Bottleneck), 3 deconv layers (256 ch, 4x4, stride 2) + BN + ReLU,
a 1x1 heatmap head, the epipolar fusion after the deconvs (MERGE='late')
merged as `fused + feat`, and the soft-argmax decode.

`init_weights(generator)` draws the JAX package's initial weights from an
explicit generator: He (fan-out) truncated normal for the trunk convs,
N(0, 0.001) for the deconvs and the heatmap head, LeCun truncated normal
for the epipolar `z`, zero biases, unit BN (zero for the zero-init BN).

Child names are the reference's (conv1, bn1, layerX.N.convK/bnK,
downsample.{0,1}, deconv_layers.{0,1,3,4,6,7}, final_layer,
epipolar_sampler.{z,bn}), so a reference state dict loads with strict=True.
The TPU's space-to-depth stem is a plain Conv2d(7, 2, 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import Config
from ..ops.soft_argmax import find_tensor_peak_batch
from .epipolar import Epipolar
from .layers import (BatchNorm2d, Conv2d, ConvTranspose2d, ZeroInitBatchNorm, bn_momentum,
                     compute_dtype)

# block type ('basic'|'bottleneck') and per-stage block counts
RESNET_SPEC = {
    "18": ("basic", (2, 2, 2, 2)),
    "34": ("basic", (3, 4, 6, 3)),
    "50": ("bottleneck", (3, 4, 6, 3)),
    "101": ("bottleneck", (3, 4, 23, 3)),
    "152": ("bottleneck", (3, 8, 36, 3)),
}


def _truncated_normal_(t: torch.Tensor, scale: float, fan: int, gen: torch.Generator):
    """flax `variance_scaling(scale, fan, 'truncated_normal')`: a normal cut
    at two standard deviations, rescaled to variance scale / fan."""
    std = (scale / fan) ** 0.5 / 0.87962566103423978
    t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std, -2 * std, 2 * std,
                                  generator=gen))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    t.copy_(torch.randn(t.shape, generator=gen) * std)


class BackboneOutput(NamedTuple):
    """Mirrors the reference PoseResNet.forward tuple (resnet.py:437)."""

    features: torch.Tensor  # deconv output (N, 256, H, W)
    heatmaps: tuple  # tuple of (N, J, H, W) stages
    locs: Optional[torch.Tensor]  # (N, J, 2) image-coord soft-argmax
    scores: Optional[torch.Tensor]  # (N, J)
    corr_pos: Optional[torch.Tensor]  # (N, H, W, 2)
    depth: Optional[torch.Tensor]  # (N, K, H, W) attention weights
    sample_locs: Optional[torch.Tensor]  # (N, K, H, W, 2)


def _bn(cfg, planes):
    return BatchNorm2d(planes, eps=1e-5, momentum=bn_momentum(cfg))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cfg, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        d = compute_dtype(cfg)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False, dtype=d)
        self.bn1 = _bn(cfg, planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=d)
        self.bn2 = _bn(cfg, planes)
        self.relu = nn.ReLU()
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes, 1, stride, bias=False, dtype=d), _bn(cfg, planes),
        ) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cfg, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        d = compute_dtype(cfg)
        out_planes = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=d)
        self.bn1 = _bn(cfg, planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False, dtype=d)
        self.bn2 = _bn(cfg, planes)
        self.conv3 = Conv2d(planes, out_planes, 1, bias=False, dtype=d)
        self.bn3 = _bn(cfg, out_planes)
        self.relu = nn.ReLU()
        self.downsample = nn.Sequential(
            Conv2d(inplanes, out_planes, 1, stride, bias=False, dtype=d),
            _bn(cfg, out_planes),
        ) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class PoseResNet(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg
        d = compute_dtype(c)
        block_type, layers = RESNET_SPEC[c.BACKBONE.BODY.split("-")[-1]]
        Block = Bottleneck if block_type == "bottleneck" else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, dtype=d)
        self.bn1 = _bn(c, 64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(n):
                s = stride if j == 0 else 1
                needs_ds = j == 0 and (s != 1 or inplanes != planes * Block.expansion)
                blocks.append(Block(c, inplanes, planes, s, needs_ds))
                inplanes = planes * Block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        deconv = []
        for _ in range(3):
            deconv += [ConvTranspose2d(inplanes, 256, 4, 2, 1, bias=False, dtype=d),
                       _bn(c, 256), nn.ReLU()]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = Conv2d(256, c.KEYPOINT.NUM_PTS, 1, bias=True, dtype=d)
        self.is_epipolar = "epipolarpose" in c.BACKBONE.BODY
        if self.is_epipolar:
            if c.EPIPOLAR.MERGE != "late":
                raise NotImplementedError(
                    f"EPIPOLAR.MERGE={c.EPIPOLAR.MERGE!r} is ROADMAP A10 (the port "
                    "merges 'late')")
            self.epipolar_sampler = Epipolar(c)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initializers (models/resnet.py, models/epipolar.py
        there), drawn from `generator` on the CPU in module order."""
        head = {id(m) for m in self.deconv_layers.modules()} | {id(self.final_layer)}
        z = getattr(getattr(self, "epipolar_sampler", None), "z", None)
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                value = 0.0 if isinstance(m, ZeroInitBatchNorm) else 1.0
                m.weight.fill_(value)
                m.bias.zero_()
                m.reset_running_stats()
            elif isinstance(m, (Conv2d, ConvTranspose2d)):
                if id(m) in head:
                    _normal_(m.weight, 0.001, generator)
                elif m is z:
                    _truncated_normal_(m.weight, 1.0, m.weight[0].numel(), generator)
                else:
                    _truncated_normal_(m.weight, 2.0, m.weight.shape[0] * m.weight[0, 0].numel(),
                                       generator)
                if m.bias is not None:
                    m.bias.zero_()

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        """Trunk + deconv, with no epipolar merge: the shared prefix of the
        reference and other passes under MERGE='late'."""
        h = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.deconv_layers(h)

    def head_from_features(self, feature, other_features=None, other_KRT=None,
                           KRT=None, decode_peaks: bool = True) -> BackboneOutput:
        """Late-merge fusion + heatmap head + decode on deconv features."""
        corr_pos = depth = sample_locs = None
        if other_features is not None and self.is_epipolar:
            fused, corr_pos, depth, sample_locs = self.epipolar_sampler(
                feature, other_features, KRT, other_KRT)
            h = fused + feature  # reference resnet.py:388
        else:
            h = feature
        heatmap = self.final_layer(h)  # (N, J, H, W)
        locs = scores = None
        if decode_peaks:
            locs, scores = find_tensor_peak_batch(
                heatmap.float(), self.cfg.KEYPOINT.SIGMA, self.cfg.BACKBONE.DOWNSAMPLE)
        return BackboneOutput(
            features=feature, heatmaps=(heatmap,), locs=locs, scores=scores,
            corr_pos=corr_pos, depth=depth, sample_locs=sample_locs,
        )

    def forward(self, x, other_features=None, other_KRT=None, KRT=None,
                decode_peaks: bool = True) -> BackboneOutput:
        """
        Args:
            x: (N, 3, H, W) reference-view images.
            other_features: (N, 256, h, w) other-view deconv features, or
                None for single-view mode.
            other_KRT / KRT: (N, 3, 4) projections for the epipolar geometry.
        """
        return self.head_from_features(self.trunk_features(x), other_features,
                                       other_KRT, KRT, decode_peaks)
