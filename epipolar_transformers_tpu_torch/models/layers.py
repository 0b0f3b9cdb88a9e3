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
n / (n - 1): 8/7 for a 1x1 map at batch 8).  On one process the running
statistics move with the moments that the normalization itself saves for
its backward (cuDNN's on the card): the batch mean, and the inverse
standard deviation 1 / sqrt(var + eps), from which the biased variance is
`invstd**-2 - eps`.  So the input is read once, by the normalization, and
no second statistics pass runs over it.

Under a process group (parallel/; one of a single rank too, which runs
the collectives as each rank of a larger group does), every BatchNorm in
training takes the moments of the global batch, all ranks' items, as
GSPMD makes them in the JAX package, whatever BACKBONE.SYNC_BN says
(ROADMAP C13): the mean and the biased variance from two all-reduces, of
the sum and then of the centred sum of squares, each differentiable
(`parallel.all_sum_differentiable`), and the running statistics move with
them as above.  torch's SyncBatchNorm would move the running variance with the
unbiased variance, and takes CUDA tensors only.  A BatchNorm whose `sync`
is off raises under more than one rank instead of training on its
rank's moments (the JAX package's GuardedBatchNorm).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import parallel


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
    batch statistics and leave the running ones untouched.

    `sync`: in training under a process group, take the global batch's
    moments (through the collectives even in a group of one rank); a
    BatchNorm with `sync` off raises under more than one rank."""

    batch_stats = False
    sync = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            if self.batch_stats:
                return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if parallel.distributed() and (self.sync or parallel.world() > 1):
            return self._global_forward(x)
        # what F.batch_norm calls, with the moments it drops: same kernels
        out, mean, invstd, _, _ = torch.ops.aten._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            self._move_running(mean, invstd.pow(-2).sub_(self.eps))
        return out

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        torch._foreach_lerp_([self.running_mean, self.running_var], [mean, var],
                             self.momentum)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training on the moments of every rank's items."""
        if not self.sync:
            raise ValueError(
                f"BatchNorm2d({self.num_features}) would train on rank {parallel.rank()}'s "
                f"own moments under a process group of {parallel.world()} ranks, where the "
                "JAX package takes the global batch's; turn its `sync` on")
        dims = (0, 2, 3)
        count = x.new_full((1,), x.numel() // x.shape[1])
        total = parallel.all_sum_differentiable(torch.cat([x.sum(dims), count]))
        mean = total[:-1] / total[-1]
        centred = x - mean.view(1, -1, 1, 1)
        var = parallel.all_sum_differentiable((centred * centred).sum(dims)) / total[-1]
        out = centred * torch.rsqrt(var + self.eps).view(1, -1, 1, 1)
        out = out * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        with torch.no_grad():
            self._move_running(mean, var)
        return out


class ZeroInitBatchNorm(BatchNorm2d):
    """BatchNorm2d with weight and bias initialized to 0 (eps 1e-5)."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum)
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)
