"""Meta (hypernetwork) fusion layer (PyTorch, NCHW).

Port of epipolar_transformers_tpu/models/meta.py (reference
modeling/layers/meta.py:9-57): the flattened fundamental matrix between the
two views feeds an MLP that emits per-sample 1x1 conv weights, applied to
the other view's features, plus a shared 1x1 conv.  As in the reference,
the per-sample conv's bias is a constant zero (the reference's
`self.bias = torch.zeros(...)` is never a parameter).
"""

from __future__ import annotations

import torch
from torch import nn

from ..geometry.camera import fundamental_matrix
from .layers import Conv2d


class Meta(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int = 100):
        super().__init__()
        self.in_channels = in_channels
        self.fc0 = nn.Linear(9, hidden_size)
        self.fc1 = nn.Linear(hidden_size, in_channels * in_channels)
        self.share = Conv2d(in_channels, in_channels, 1, bias=True)

    def forward(self, KRT: torch.Tensor, other_KRT: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """KRT, other_KRT: (N, 3, 4); x: (N, C, H, W) other-view features."""
        C = self.in_channels
        F = fundamental_matrix(KRT.float(), other_KRT.float())  # (N, 3, 3)
        hidden = torch.relu(self.fc0(F.reshape(-1, 9)))
        weight = self.fc1(hidden).reshape(-1, C, C)  # (N, Cout, Cin)
        out = torch.einsum("nchw,noc->nohw", x, weight)
        return out + self.share(x)
