"""The benchmark's plain reference of the stacked epipolar hourglass (the
reference code's `modeling/backbones/ProHG.py`, the registered `epipolarHG`
body: 3 stacks of 1 module, recursion 3), its stage loss and adam, in plain
torch: the reference module of a configuration file that names
`"reference": "hourglass"` (the contract is in `reference/__init__.py`).

The network (NFEATS channels, 256 here):

- a pre-activation bottleneck `Residual`: BN, ReLU and a 1x1 convolution to
  half the width, BN, ReLU and a 3x3 one, BN, ReLU and a 1x1 one to the
  output width, plus the input, or BN, ReLU and a 1x1 `branch` of it where
  the widths differ; every convolution carries a bias;
- the stem: a 3x3 stride-2 convolution to 32 channels, two 3x3 ones (32,
  64), each with BN and ReLU, then `ress0` (64 -> 128), a 3x3 stride-2 max
  pool, `ress1` (128) and `ress2` (128 -> NFEATS): 256 px in, 64x64 out;
- a recursive `Hourglass` of depth n: `res0` of the input; a 2x2 max pool,
  `down0`, the hourglass of depth n - 1 (a `mid0` residual at depth 1) and
  `up0`; the bilinear align-corners upsample of that back to the input's
  size, added to `res0`'s output (64x64 down to 8x8 at depth 3);
- each stack i: its hourglass, `tower{i}_mod0`, a 1x1 `tower{i}_conv`, BN
  and ReLU; the late epipolar fusion of that map with the other view's map
  of the same stack (`model.EpipolarFusion`, one module shared by every
  stack: the attention over K samples along each pixel's epipolar line,
  `z`, BN and the residual `out` add), plus the map itself; the head
  `tmpOut{i}` (1x1 to NUM_PTS joints); before the next stack, the stack's
  input plus `trsfea{i}` of the fused map plus `trstmp{i}` of the heads;
- the other view runs first, through the same modules without the fusion
  (and without the last stack's head, which nothing reads), each BN on its
  own batch moments; then the reference view;
- the loss (`compute_stage_loss`, KEYPOINT.LOSS 'mse'): the sum over the
  stacks of the mean squared difference of each stack's heatmaps and the
  target, with no visibility weight.

The call returns the last stack's heatmaps, the ones a run compares; the
tensor carries every stack's, in order, as its attribute `stages`, which
`loss` sums over (a tensor without it is one stack's).

Departures from ProHG.py: the convolutions' and BatchNorms' arithmetic,
the attention, and the BN running statistics, which move with the biased
batch variance, are `model`'s (its docstring); BatchNorm's momentum is
0.1.  `precision` rounds the convolutions as in `model`, and "float64"
(this module's own, for the CPU tests) computes every layer in float64 on
a model made float64.  It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..harness import weights
from . import model

# the `epipolarHG` body's stacks and recursion depth
BODY, STACKS, DEPTH = "epipolarHG", 3, 3

# the seed's draw: the heads, the re-injections and `z` are followed by no
# ReLU; the stem's and the towers' BNs, whose names the defaults do not
# read as a BN's, take the small scale (their shifts the bias's 0.01)
weight_rules = {
    "no_relu_after": weights.NO_RELU_AFTER + tuple(
        f"{name}{i}.weight" for i in range(STACKS) for name in ("tmpOut", "trsfea", "trstmp")),
    "scaled_branch_bn": weights.SCALED_BRANCH_BN + tuple(
        f"stem_bn{i}.weight" for i in range(3)) + tuple(
        f"tower{i}_bn.weight" for i in range(STACKS)),
}


class Conv(model.Conv):
    """`model.Conv`, and in "float64" a float64 convolution."""

    def forward(self, x):
        if self.precision != "float64":
            return super().forward(x)
        b = None if self.bias is None else self.bias.double()
        return F.conv2d(x.double(), self.weight.double(), b, self.stride, self.pad)


class BN(model.BN):
    """`model.BN` in its parameters' dtype: float32, or float64 on a model
    made float64."""

    def forward(self, x):
        if self.weight.dtype != torch.float64:
            return super().forward(x)
        x = x.double()
        if self.training:
            y, mean, var = model._TrainBN.apply(x, self.weight, self.bias, 1e-5)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            return y
        inv = torch.rsqrt(self.running_var + 1e-5)
        return (x - self.running_mean[:, None, None]) * (inv * self.weight)[:, None, None] \
            + self.bias[:, None, None]


class Fusion(model.EpipolarFusion):
    """`model.EpipolarFusion` on this module's `Conv` and `BN`, in their dtype."""

    def __init__(self, c: int, precision: str):
        super().__init__(c, precision)
        self.z = Conv(c, c, 1, bias=True, precision=precision)
        self.bn = BN(c)

    def forward(self, feat, other, locs):
        dtype = self.bn.weight.dtype
        out = self.attend(feat.to(dtype), other.to(dtype), locs.to(dtype))
        return self.bn(self.z(out)) + out


class Residual(nn.Module):
    def __init__(self, cin: int, cout: int, p: str):
        super().__init__()
        mid = cout // 2
        self.bnA = BN(cin)
        self.convA = Conv(cin, mid, 1, bias=True, precision=p)
        self.bnB = BN(mid)
        self.convB = Conv(mid, mid, 3, 1, 1, bias=True, precision=p)
        self.bnC = BN(mid)
        self.convC = Conv(mid, cout, 1, bias=True, precision=p)
        self.project = cin != cout
        if self.project:
            self.bnR = BN(cin)
            self.branch = Conv(cin, cout, 1, bias=True, precision=p)

    def forward(self, x):
        h = self.convA(F.relu(self.bnA(x)))
        h = self.convB(F.relu(self.bnB(h)))
        h = self.convC(F.relu(self.bnC(h)))
        return h + (self.branch(F.relu(self.bnR(x))) if self.project else x)


class Hourglass(nn.Module):
    def __init__(self, depth: int, c: int, p: str):
        super().__init__()
        self.res0 = Residual(c, c, p)
        self.down0 = Residual(c, c, p)
        if depth > 1:
            self.mid = Hourglass(depth - 1, c, p)
        else:
            self.mid0 = Residual(c, c, p)
        self.up0 = Residual(c, c, p)

    def forward(self, x):
        res = self.res0(x)
        down = self.down0(F.max_pool2d(res, 2, 2))
        mid = self.mid(down) if hasattr(self, "mid") else self.mid0(down)
        return res + F.interpolate(self.up0(mid), size=res.shape[-2:], mode="bilinear",
                                   align_corners=True)


class StackedHourglass(nn.Module):
    """The stem, the stacks and the fusion (the module docstring), named as
    the published code names them."""

    def __init__(self, stacks: int, depth: int, c: int, joints: int, p: str = "float32"):
        super().__init__()
        self.stacks = stacks
        for i, (cin, cout) in enumerate(((3, 32), (32, 32), (32, 64))):
            setattr(self, f"stem_conv{i}", Conv(cin, cout, 3, 2 if i == 0 else 1, 1,
                                                bias=True, precision=p))
            setattr(self, f"stem_bn{i}", BN(cout))
        self.ress0 = Residual(64, 128, p)
        self.ress1 = Residual(128, 128, p)
        self.ress2 = Residual(128, c, p)
        for i in range(stacks):
            setattr(self, f"hg{i}", Hourglass(depth, c, p))
            setattr(self, f"tower{i}_mod0", Residual(c, c, p))
            setattr(self, f"tower{i}_conv", Conv(c, c, 1, bias=True, precision=p))
            setattr(self, f"tower{i}_bn", BN(c))
            setattr(self, f"tmpOut{i}", Conv(c, joints, 1, bias=True, precision=p))
            if i < stacks - 1:
                setattr(self, f"trsfea{i}", Conv(c, c, 1, bias=True, precision=p))
                setattr(self, f"trstmp{i}", Conv(joints, c, 1, bias=True, precision=p))
        self.epipolar_sampler = Fusion(c, p)

    def run(self, x, others: Optional[List[torch.Tensor]] = None, locs=None):
        """(each stack's map, each stack's heatmaps) of images `x`, each map
        fused with `others`' of its stack where they are given (the last
        stack's heatmaps only then)."""
        h = x
        for i in range(3):
            h = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(h)))
        h = self.ress2(self.ress1(F.max_pool2d(self.ress0(h), 3, 2, 1)))
        maps, heads = [], []
        for i in range(self.stacks):
            f = getattr(self, f"hg{i}")(h)
            f = getattr(self, f"tower{i}_mod0")(f)
            f = F.relu(getattr(self, f"tower{i}_bn")(getattr(self, f"tower{i}_conv")(f)))
            if others is not None:
                f = self.epipolar_sampler(f, others[i], locs) + f
            maps.append(f)
            if i < self.stacks - 1:
                hm = getattr(self, f"tmpOut{i}")(f)
                heads.append(hm)
                h = h + getattr(self, f"trsfea{i}")(f) + getattr(self, f"trstmp{i}")(hm)
            elif others is not None:
                heads.append(getattr(self, f"tmpOut{i}")(f))
        return maps, heads

    def forward(self, img, other_img, locs):
        """The reference view's last heatmaps (N, J, h, w), every stack's
        under `.stages`."""
        others, _ = self.run(other_img)
        _, heads = self.run(img, others, locs)
        out = heads[-1]
        out.stages = tuple(heads)
        return out


def _model(recipe: Dict, precision: str = "float32") -> StackedHourglass:
    if recipe["BACKBONE"]["BODY"] != BODY:
        raise ValueError(f"reference/hourglass.py is the {BODY} body's, not "
                         f"{recipe['BACKBONE']['BODY']!r}'s")
    k = recipe["KEYPOINT"]
    return StackedHourglass(STACKS, DEPTH, int(k.get("NFEATS", 256)), int(k["NUM_PTS"]),
                            precision)


def build(recipe: Dict, precision: str, state: Dict[str, torch.Tensor],
          device) -> StackedHourglass:
    """The reference on `device` with `state` (names as `state_shapes` gives)."""
    with torch.device(device):
        m = _model(recipe, precision)
    if precision == "float64":
        m.double()
    m.load_state_dict(state, strict=True)
    return m


def state_shapes(recipe: Dict) -> Dict[str, tuple]:
    """Every parameter's and buffer's name and shape, without allocating."""
    with torch.device("meta"):
        m = _model(recipe)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def loss(heatmaps: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum over the stacks of mean((heatmaps - target)^2)."""
    target = batch["heatmap"].to(heatmaps.dtype)
    return sum(((h - target) ** 2).mean() for h in getattr(heatmaps, "stages", (heatmaps,)))


def forward_flops(recipe: Dict) -> int:
    """The forward's FLOPs on one item (both views): the convolutions and,
    at each stack, the attention's two einsums (2 HW K C each)."""
    with torch.device("meta"):
        m = _model(recipe)
    return model.count_forward_flops(m, recipe)


def attention_bound(locs: torch.Tensor, recipe: Dict, dtype: str,
                    backward: bool) -> Dict[str, float]:
    """The least time of one window call's attention at these locations:
    the step's three fusion calls, one a stack, each at the same locations
    and `model.attention_bound`'s; its flops and bytes are the calls' sum."""
    one = model.attention_bound(locs, recipe, dtype, backward)
    return {"seconds": STACKS * one["seconds"], "flops": STACKS * one["flops"],
            "bytes": STACKS * one["bytes"], "bound_by": one["bound_by"]}
