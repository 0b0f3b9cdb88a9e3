"""The benchmark's plain reference of the epipolar PoseResNet, its loss and
adam, in plain torch.

Follows the published model (He et al., "Epipolar Transformers", CVPR
2020, and its reference code's PoseResNet, epipolar layer and
JointsMSELoss): a ResNet trunk (Bottleneck stride on the 3x3 conv), three
4x4 stride-2 deconvolutions of 256 channels with BN and ReLU, the late
epipolar fusion with shared weights (dot similarity over K bilinear
samples of the other view's features along each pixel's epipolar line,
softmax at 1/sqrt(K) over the samples that fall in the image, the
weighted sum of the same samples, then a 1x1 `z` convolution, BN and the
residual adds), and a 1x1 heatmap head.  BatchNorm trains on the batch's
moments with the biased variance and moves its running statistics with
that same variance (the flax convention of the JAX original).

Parameter names are the published code's (conv1, layer1.0.conv1, ...,
deconv_layers.0, final_layer, epipolar_sampler.z, epipolar_sampler.bn).

`precision` says how the convolutions compute: "float32" (the caller
turns TF32 off, or on for a configuration that computes in TF32),
"bfloat16" (inputs and weights rounded to bfloat16, the product and its
gradients in bfloat16), or "float8" (inputs and weights rounded to float8
e4m3 under a per-tensor scale and multiplied in float32, the gradient
passed straight through the rounding in float32, as float8 training keeps
its gradients wider).  Everything else computes in float32.  It imports
nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


# depth -> (block, blocks per stage)
BLOCKS = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3)),
          152: ("bottleneck", (3, 8, 36, 3))}
FP8_MAX = 448.0  # largest float8 e4m3 value
NEG_INF = -1e10  # logit of a sample outside the image
# cuDNN's grid sampler refuses an output of 2**31 elements or more: the
# (N, C, K, HW) samples of 32 items at 96x96, K=64, C=256 hold 4.8e9
SAMPLE_ELEMENTS = 2 ** 31 - 1


def round_to(t: torch.Tensor, precision: str) -> torch.Tensor:
    """`t` rounded to `precision` (float8: under a per-tensor scale)."""
    if precision == "bfloat16":
        return t.to(torch.bfloat16)
    if precision == "float8":
        t = t.float()
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return t + (rounded - t.detach())
    return t.float()


class Conv(nn.Module):
    """A convolution (or a transposed one) in the model's precision."""

    def __init__(self, cin, cout, k, stride=1, pad=0, bias=False, transposed=False,
                 precision="float32"):
        super().__init__()
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.pad, self.transposed, self.precision = stride, pad, transposed, precision

    def forward(self, x):
        p = self.precision
        x, w = round_to(x, p), round_to(self.weight, p)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.transposed:
            y = F.conv_transpose2d(x, w, b, self.stride, self.pad)
        else:
            y = F.conv2d(x, w, b, self.stride, self.pad)
        return y.float()


class _TrainBN(torch.autograd.Function):
    """BatchNorm on the batch's moments, y = (x - mean) rsqrt(var + eps) w
    + b over (N, H, W), that saves its input alone for the backward and
    takes the textbook gradient there; it also returns the batch's mean and
    biased variance.  Autograd of the same expression would hold x - mean
    as well, which does not fit beside R-152's activations at 384 px and
    batch 32 on one card."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, w, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return (x - mean[:, None, None]) * (inv * w)[:, None, None] + b[:, None, None], mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, w, mean, inv = ctx.saved_tensors
        m = x.numel() // x.shape[1]
        xhat = (x - mean[:, None, None]) * inv[:, None, None]
        gb = gy.sum(dim=(0, 2, 3))
        gw = (gy * xhat).sum(dim=(0, 2, 3))
        gx = (gy - (gb / m)[:, None, None] - xhat * (gw / m)[:, None, None]) \
            * (inv * w)[:, None, None]
        return gx, gw, gb, None


class BN(nn.Module):
    """BatchNorm in float32 (eps 1e-5, momentum 0.1): batch moments and a
    biased-variance running update in training, running statistics else."""

    def __init__(self, c, momentum=0.1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum = momentum

    def forward(self, x):
        x = x.float()
        if self.training:
            y, mean, var = _TrainBN.apply(x, self.weight, self.bias, 1e-5)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            return y
        mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5)
        return (x - mean[:, None, None]) * (inv * self.weight)[:, None, None] \
            + self.bias[:, None, None]


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, down, precision):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1, precision=precision)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, precision=precision)
        self.bn2 = BN(planes)
        self.downsample = nn.Sequential(Conv(cin, planes, 1, stride, precision=precision),
                                        BN(planes)) if down else None

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + skip)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, down, precision):
        super().__init__()
        out = planes * 4
        self.conv1 = Conv(cin, planes, 1, precision=precision)
        self.bn1 = BN(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, precision=precision)
        self.bn2 = BN(planes)
        self.conv3 = Conv(planes, out, 1, precision=precision)
        self.bn3 = BN(out)
        self.downsample = nn.Sequential(Conv(cin, out, 1, stride, precision=precision),
                                        BN(out)) if down else None

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        return F.relu(self.bn3(self.conv3(h)) + skip)


class EpipolarFusion(nn.Module):
    """The late fusion with shared key/value weights and `z` + BN + residual."""

    def __init__(self, c, precision):
        super().__init__()
        self.z = Conv(c, c, 1, bias=True, precision=precision)
        self.bn = BN(c)

    def attend(self, feat, other, locs):
        """feat, other (N, C, H, W); locs (N, K, H, W, 2) -> (N, C, H, W).
        Each item attends alone, so a batch whose samples would pass
        `SAMPLE_ELEMENTS` attends item by item, each item recomputed in the
        backward, so that one item's samples are held at a time."""
        N, C, H, W = feat.shape
        if N * C * locs.shape[1] * H * W <= SAMPLE_ELEMENTS:
            return self._attend(feat, other, locs)
        return torch.cat([checkpoint(self._attend, feat[i:i + 1], other[i:i + 1],
                                     locs[i:i + 1], use_reentrant=False) for i in range(N)])

    def _attend(self, feat, other, locs):
        N, C, H, W = feat.shape
        K = locs.shape[1]
        samples = F.grid_sample(other, locs.reshape(N, K, H * W, 2), mode="bilinear",
                                padding_mode="zeros", align_corners=True)  # (N, C, K, HW)
        q = feat.reshape(N, C, H * W)
        sim = torch.einsum("ncp,nckp->nkp", q, samples)
        logits = torch.where(sim == 0.0, NEG_INF, sim) / math.sqrt(K)
        weights = torch.softmax(logits, dim=1)
        return torch.einsum("nkp,nckp->ncp", weights, samples).reshape(N, C, H, W)

    def forward(self, feat, other, locs):
        out = self.attend(feat.float(), other.float(), locs)
        return self.bn(self.z(out)) + out


class PoseResNet(nn.Module):
    def __init__(self, depth: int, joints: int, precision: str = "float32"):
        super().__init__()
        p = precision
        self.conv1 = Conv(3, 64, 7, 2, 3, precision=p)
        self.bn1 = BN(64)
        cin = 64
        kind, counts = BLOCKS[depth]
        Block = Bottleneck if kind == "bottleneck" else Basic
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                down = j == 0 and (stride != 1 or cin != planes * Block.expansion)
                blocks.append(Block(cin, planes, stride, down, p))
                cin = planes * Block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        deconv: List[nn.Module] = []
        for _ in range(3):
            deconv += [Conv(cin, 256, 4, 2, 1, transposed=True, precision=p), BN(256), nn.ReLU()]
            cin = 256
        self.deconv_layers = nn.Sequential(*deconv)
        self.final_layer = Conv(256, joints, 1, bias=True, precision=p)
        self.epipolar_sampler = EpipolarFusion(256, p)

    def features(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.deconv_layers(h)

    def head(self, feat, other, locs):
        return self.final_layer(self.epipolar_sampler(feat, other, locs) + feat)

    def forward(self, img, other_img, locs):
        """Heatmaps (N, J, h, w) of `img` fused with `other_img`.  In
        training the other view runs first and then the reference view, each
        with its own batch moments; at eval both take the running ones."""
        other = self.features(other_img)
        return self.head(self.features(img), other, locs)


def joints_mse(heatmaps, target, visibility):
    """JointsMSELoss averaged over joints: the mean over items and pixels of
    the squared visibility-weighted difference, summed over joints, / J."""
    v = visibility[:, :, None, None]
    return (((heatmaps - target) * v) ** 2).mean(dim=(0, 2, 3)).sum() / heatmaps.shape[1]


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8, bias-corrected,
    no weight decay) written out."""

    def __init__(self, params: List[nn.Parameter], lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1 - self.b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


def build(depth: int, joints: int, precision: str, state: Dict[str, torch.Tensor],
          device) -> PoseResNet:
    """The reference on `device` with `state` (names as `state_names` gives)."""
    with torch.device(device):
        model = PoseResNet(depth, joints, precision)
    model.load_state_dict(state, strict=True)
    return model


def state_shapes(depth: int, joints: int) -> Dict[str, tuple]:
    """Every parameter's and buffer's name and shape, without allocating."""
    with torch.device("meta"):
        model = PoseResNet(depth, joints)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def forward_flops(sizes) -> int:
    """The reference forward's FLOPs on one item (two views), as
    FlopCounterMode counts them on meta tensors: 2 per multiply-add of every
    convolution, transposed ones included, and of the attention's two
    einsums (2 HW K C each); nothing elementwise.  `sizes` has the recipe's
    depth, joints, image and heatmap sizes and samples."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = PoseResNet(sizes.depth, sizes.joints)
        img = torch.empty(1, 3, *sizes.image_hw)
        locs = torch.empty(1, sizes.samples, *sizes.heatmap_hw, 2)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(img, img, locs)
    return int(counter.get_total_flops())

