"""The benchmark's plain reference of the paper's fully parameterized
epipolar transformer (He et al., "Epipolar Transformers", CVPR 2020, and
its reference code's `configs/epipolar/keypoint_h36m_param.yaml` with the
epipolar layer's theta/phi/g branch), in plain float32 torch: the
reference module of a configuration file that names `"reference":
"param"` (the contract is in `reference/__init__.py`).

It is `model`'s PoseResNet, deconv head, loss pieces and adam with another
fusion (`ParamFusion`, the module `epipolar_sampler`):

- `theta`, `phi` and `g`: 1x1 convolutions with bias from the features
  (NFEATS, 256) to NFEATS / BOTTLENECK (128) channels, on the reference
  view's features (queries) and on the other view's (keys, values);
- K bilinear samples of the keys and of the values along each pixel's
  epipolar line (`F.grid_sample`, align_corners, zero padding) at the
  harness's locations, mapped to the recipe's own normalization
  (USE_CORRECT_NORMALIZE False: pixel p at -1 + 2 (p + 1/2) / W, which
  the sampler reads as the align-corners coordinate, `published`);
- the pairs (k, k + K/2) max-reduced on the features, keys and values
  apart, which leaves K/2 slots;
- dot similarity, an exact zero (a pair with no corner in the image)
  masked to -1e10, softmax at 1/sqrt(K) over the K/2 slots, and the
  weighted sum of the pooled values;
- `z`: a 1x1 convolution with bias back to NFEATS channels, then BN, with
  no residual add (ZRESIDUAL False); the head takes the fused features plus
  the reference view's own into the heatmap layer of NUM_PTS (20) joints;
- the loss: JointsMSELoss summed over the joints (LOSS_PER_JOINT's
  published default, True).

Departures from the published description: none in the arithmetic.  The
published code computes the attention in float32 on float32 features; here
it does too, whatever `precision` says (which, as in `model`, rounds the
convolutions alone).  It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..harness import weights, work
from . import model
from .model import BN, NEG_INF, Conv, PoseResNet

# the seed's draw: no ReLU follows theta, phi, g or z; the fusion's BN is no
# residual branch's last, so it takes the default scale
weight_rules = {
    "no_relu_after": weights.NO_RELU_AFTER + tuple(
        f"epipolar_sampler.{name}.weight" for name in ("theta", "phi", "g")),
    "scaled_branch_bn": ("bn3.weight",),
}


def published(locs: torch.Tensor) -> torch.Tensor:
    """(N, K, H, W, 2) align-corners locations in (-1, 1) -> the recipe's
    uncorrected ones, -1 + 2 (p + 1/2) / W of the same pixel p (computed in
    float64, returned in the input's dtype)."""
    H, W = locs.shape[2:4]
    size = torch.tensor([W, H], dtype=torch.float64, device=locs.device)
    pix = (locs.double() + 1.0) * (size - 1.0) / 2.0
    return (-1.0 + 2.0 * (pix + 0.5) / size).to(locs.dtype)


class ParamFusion(nn.Module):
    """theta/phi/g, pooled attention, z and BN (the module docstring)."""

    def __init__(self, c: int, bottleneck: int, precision: str = "float32"):
        super().__init__()
        inner = c // bottleneck
        self.theta = Conv(c, inner, 1, bias=True, precision=precision)
        self.phi = Conv(c, inner, 1, bias=True, precision=precision)
        self.g = Conv(c, inner, 1, bias=True, precision=precision)
        self.z = Conv(inner, c, 1, bias=True, precision=precision)
        self.bn = BN(c)

    def attend(self, q, keys, values, locs):
        """q, keys, values (N, C, H, W); locs (N, K, H, W, 2), align-corners
        -> (N, C, H, W)."""
        N, C, H, W = q.shape
        K = locs.shape[1]
        grid = published(locs).reshape(N, K, H * W, 2)

        def pooled(features):  # (N, C, K, HW) samples, pairs max-reduced
            s = F.grid_sample(features, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
            return torch.maximum(s[:, :, :K // 2], s[:, :, K // 2:])

        k, v = pooled(keys), pooled(values)
        sim = torch.einsum("ncp,nckp->nkp", q.reshape(N, C, H * W), k)
        logits = torch.where(sim == 0.0, NEG_INF, sim) / math.sqrt(K)
        w = torch.softmax(logits, dim=1)
        return torch.einsum("nkp,nckp->ncp", w, v).reshape(N, C, H, W)

    def forward(self, feat, other, locs):
        out = self.attend(self.theta(feat), self.phi(other), self.g(other), locs)
        return self.bn(self.z(out))


def _model(recipe: Dict, precision: str = "float32") -> PoseResNet:
    e = recipe["EPIPOLAR"]
    c = int(recipe["KEYPOINT"].get("NFEATS", 256))
    return PoseResNet(*model.dims(recipe), precision,
                      fusion=ParamFusion(c, int(e["BOTTLENECK"]), precision))


def build(recipe: Dict, precision: str, state: Dict[str, torch.Tensor], device) -> PoseResNet:
    """The reference on `device` with `state` (names as `state_shapes` gives)."""
    with torch.device(device):
        m = _model(recipe, precision)
    m.load_state_dict(state, strict=True)
    return m


def state_shapes(recipe: Dict) -> Dict[str, tuple]:
    """Every parameter's and buffer's name and shape, without allocating."""
    with torch.device("meta"):
        m = _model(recipe)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def loss(heatmaps: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """JointsMSELoss summed over the joints (LOSS_PER_JOINT True)."""
    return model.loss(heatmaps, batch) * heatmaps.shape[1]


def forward_flops(recipe: Dict) -> int:
    """The forward's FLOPs on one item: the convolutions (theta, phi, g and
    z among them) and the attention's two einsums over the K/2 slots."""
    with torch.device("meta"):
        m = _model(recipe)
    return model.count_forward_flops(m, recipe)


def attention_bound(locs: torch.Tensor, recipe: Dict, dtype: str,
                    backward: bool) -> Dict[str, float]:
    """The least seconds of one pooled attention call at these (harness,
    align-corners) locations, its queries, keys and values (B, HW, C) handed
    over in `dtype`: {"seconds", "flops", "bytes", "bound_by"}.

    Operations, with P the live (query, key row) pairs of the K samples'
    corners at the recipe's own normalization (`work.live_pairs`) and S =
    K/2 slots: the forward reads each live pair's row for the keys and for
    the values (2 P 2C), takes the pair max of both stacks (2 B HW S C) and
    computes the two einsums (2 x 2 B HW S C); the backward routes both
    stacks' gradients through the max (2 B HW S C), computes the four
    products of the einsums' gradients (4 x 2 B HW S C) and scatters to the
    live rows of the keys and of the values (2 P 2C).  Bytes: each input
    read once and each output written once, at its element size (the
    locations float32): the forward reads queries, keys, values and the
    locations and writes the output; the backward reads those and the
    output's gradient and writes the three inputs' gradients."""
    B, K, H, W, _ = locs.shape
    C = int(recipe["KEYPOINT"].get("NFEATS", 256)) // int(recipe["EPIPOLAR"]["BOTTLENECK"])
    S, HW = K // 2, H * W
    e = work.ELEMENT_BYTES[dtype]
    feature = B * HW * C * e
    dense = 2 * B * HW * S * C  # one einsum over the slots
    rows = 2 * work.live_pairs(published(locs)) * 2 * C  # keys and values
    if backward:
        flops = rows + 4 * dense + dense
        nbytes = 7 * feature + locs.numel() * 4
    else:
        flops = rows + 2 * dense + dense
        nbytes = 4 * feature + locs.numel() * 4
    t_ops, t_bytes = flops / work.PEAK_FLOPS[dtype], nbytes / work.PEAK_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "flops": float(flops), "bytes": float(nbytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
