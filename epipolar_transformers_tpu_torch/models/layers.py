"""Shared small layers (PyTorch, NCHW).

Mixed precision follows the JAX package: parameters and BatchNorm
statistics stay float32; under `DTYPE: bfloat16` a convolution casts its
input and parameters to bfloat16 and returns bfloat16, and BatchNorm
normalizes in float32 and returns float32 (flax's BatchNorm promotes a
bfloat16 input with its float32 parameters).

ZeroInitBatchNorm is the reference's `zeroinitBN` (modeling/layers/BN.py:
12-101): affine weight AND bias start at zero, so the epipolar fusion
branch starts as an exact identity under the residual add.

In training, BatchNorm follows flax's `nn.BatchNorm`, not torch's: both
normalize with the biased batch variance, but flax also moves the running
variance with the biased one where torch uses the unbiased one (a factor
n / (n - 1): 8/7 for a 1x1 map at batch 8).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def compute_dtype(cfg) -> torch.dtype:
    """Convolution compute dtype; parameters stay float32."""
    return torch.bfloat16 if cfg.DTYPE == "bfloat16" else torch.float32


def bn_momentum(cfg) -> float:
    """BACKBONE.BN_MOMENTUM in torch's convention (negative means 0.1)."""
    m = cfg.BACKBONE.BN_MOMENTUM
    return 0.1 if m < 0 else m


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `dtype` over float32 parameters."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in `dtype` over float32 parameters."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.conv_transpose2d(x.to(d), self.weight.to(d), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` that normalizes in float32 and returns float32
    (float64 for a float64 input, as the parity tests run it), and
    in training moves its running statistics as flax does: with the biased
    batch variance, `running = (1 - momentum) running + momentum batch`.

    `batch_stats` (TEST.TRAIN_BN): outside training, normalize with the
    batch statistics and leave the running ones untouched."""

    batch_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            if self.batch_stats:
                return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return out


class ZeroInitBatchNorm(BatchNorm2d):
    """BatchNorm2d with weight and bias initialized to 0 (eps 1e-5)."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)
