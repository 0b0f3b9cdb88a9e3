"""2D -> 3D lifting network (PyTorch, NCHW).

Port of epipolar_transformers_tpu/models/lifting.py (reference
modeling/lifting.py:8-205): heatmaps, or image features for
`img_lifting_rot`, -> canonical 3D joints through the PosePrior conv + MLP
stack, and for the *_rot tasks a viewpoint head whose axis-angle output
becomes a rotation (Rodrigues); the handedness flip; the multiview fusion's
rotation into the global frame.

Child names are the reference's, so a reference-layout state dict loads as
it is: `conv1` and `conv2` are Sequentials of (3x3 conv, LeakyReLU) x6
(convs at 0, 2, ..., 10), `poseprior` and `viewpoint` Sequentials of
(Linear, LeakyReLU, Dropout) x2 + Linear (Linears at 0, 3, 6), or single
Linears on image features.

Pinned differences, each following the JAX package:
  * the heatmaps are average-pooled with floored windows (flax
    `nn.avg_pool`, VALID), not torch's `ceil_mode=True` of the reference:
    at a size the pool does not divide, the last partial window is dropped;
  * the conv features flatten NCHW, as the reference does; the JAX package
    flattens NHWC, so its `fc0` rows are permuted on import
    (utils/jax_import.py), the hand-side columns staying at the end;
  * dropout draws its masks from a `torch.Generator` on the input's device,
    seeded with cfg.SEED (or `seed_dropout`), never from the global RNG, so
    that two runs are bit-equal.

The hand-side one-hot (RHD) is appended after the flatten; whether the
net takes it is fixed at construction (`hand_side`), since it sets the
first dense layers' widths.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..config import Config
from .resnet import _truncated_normal_

LRELU_SLOPE = 0.01  # torch nn.LeakyReLU default
POOL2_TASKS = ("keypoint_lifting_rot", "multiview_img_lifting_rot")
DIRECT_TASKS = ("lifting", "lifting_direct", "keypoint_lifting_direct")


def rodrigues(y: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3), with the
    reference's 1e-8 norm regularizer (reference lifting.py:154-177)."""
    theta = torch.sqrt(torch.sum(y ** 2, dim=1) + 1e-8)
    st, ct = torch.sin(theta), torch.cos(theta)
    one_ct = 1.0 - ct
    ux, uy, uz = (y / theta[:, None]).unbind(1)
    rows = torch.stack([
        ct + ux * ux * one_ct, ux * uy * one_ct - uz * st, ux * uz * one_ct + uy * st,
        uy * ux * one_ct + uz * st, ct + uy * uy * one_ct, uy * uz * one_ct - ux * st,
        uz * ux * one_ct - uy * st, uz * uy * one_ct + ux * st, ct + uz * uz * one_ct,
    ], dim=1)
    return rows.reshape(-1, 3, 3)


def flip_right_hand(coords: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Mirror z for right hands (reference lifting.py:181-187)."""
    mirror = torch.tensor([1.0, 1.0, -1.0], dtype=coords.dtype, device=coords.device)
    return torch.where(side.reshape(-1, 1, 1).bool(), coords * mirror, coords)


def multiview_to_global(coords: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Per-view normed predictions into the global frame: x @ (R^-1)^T
    (reference lifting.py:189-199)."""
    return coords @ torch.linalg.inv(R).transpose(1, 2)


class _GeneratorSlot:
    """The dropout generator that a LiftingNet's dropout layers share, made
    on first use on the input's device from `seed`."""

    def __init__(self, seed: int):
        self.seed = seed
        self.generator: Optional[torch.Generator] = None

    def get(self, device: torch.device) -> torch.Generator:
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device).manual_seed(self.seed)
        return self.generator


class Dropout(nn.Module):
    """Inverted dropout whose masks come from the shared generator slot."""

    def __init__(self, p: float, slot: _GeneratorSlot):
        super().__init__()
        self.p = p
        self.slot = slot

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.slot.get(x.device))
        return x * keep / (1.0 - self.p)


def _conv_stack(in_channels: int, widths) -> nn.Sequential:
    """(3x3 conv + LeakyReLU) x6, stride 2 on the second of each pair
    (reference lifting.py:24-41)."""
    layers = []
    for w in widths:
        layers += [nn.Conv2d(in_channels, w, 3, 1, 1), nn.LeakyReLU(LRELU_SLOPE),
                   nn.Conv2d(w, w, 3, 2, 1), nn.LeakyReLU(LRELU_SLOPE)]
        in_channels = w
    return nn.Sequential(*layers)


def _mlp_head(in_features: int, widths, out_dim: int, p: float, slot) -> nn.Sequential:
    layers = []
    for w in widths:
        layers += [nn.Linear(in_features, w), nn.LeakyReLU(LRELU_SLOPE), Dropout(p, slot)]
        in_features = w
    return nn.Sequential(*layers, nn.Linear(in_features, out_dim))


def conv_out_size(cfg: Config) -> Tuple[int, int]:
    """The conv stacks' output (h, w) on cfg's heatmaps: the floored pool,
    then three stride-2 convs with padding 1 (each ceil(s / 2))."""
    pool = 2 if cfg.DATASETS.TASK in POOL2_TASKS else 8
    h, w = (s // pool for s in cfg.KEYPOINT.HEATMAP_SIZE)
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class LiftingNet(nn.Module):
    """Args:
        cfg: the task (DATASETS.TASK), KEYPOINT.NUM_PTS and HEATMAP_SIZE
            (the heatmaps' size, which sets the dense widths), LIFTING.FLIP_ON
            and SEED (the dropout generator's seed).
        in_features: the image features' width (`img_lifting_rot`).
        hand_side: whether the net takes the hand-side one-hot (RHD).
    """

    def __init__(self, cfg: Config, in_features: int = 0, hand_side: bool = False):
        super().__init__()
        self.cfg = cfg
        task = cfg.DATASETS.TASK
        if task not in DIRECT_TASKS and "lifting_rot" not in task:
            raise NotImplementedError(f"LiftingNet has no task {task!r}")
        self.image_features = task == "img_lifting_rot"
        self.direct = task in DIRECT_TASKS
        self.hand_side = hand_side
        self._slot = _GeneratorSlot(cfg.SEED)
        side = 2 if hand_side else 0
        out = cfg.KEYPOINT.NUM_PTS * 3
        if self.image_features:
            self.poseprior = nn.Linear(in_features + side, out)
            self.viewpoint = nn.Linear(in_features + side, 3)
            return
        self.pool = 2 if task in POOL2_TASKS else 8
        h, w = conv_out_size(cfg)
        J = cfg.KEYPOINT.NUM_PTS
        self.conv1 = _conv_stack(J, (32, 64, 128))
        self.poseprior = _mlp_head(128 * h * w + side, (512, 512), out, 0.2, self._slot)
        if not self.direct:
            self.conv2 = _conv_stack(J, (64, 128, 256))
            self.viewpoint = _mlp_head(256 * h * w + side, (256, 128), 3, 0.25, self._slot)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults, as the JAX LiftingNet has them: LeCun (fan-in)
        truncated normal kernels, zero biases; drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _truncated_normal_(m.weight, 1.0, m.weight[0].numel(), generator)
                m.bias.zero_()

    def seed_dropout(self, seed: int) -> None:
        """Restart the dropout masks from `seed`."""
        self._slot.seed = seed
        self._slot.generator = None

    def forward(self, x: torch.Tensor, hand_side: Optional[torch.Tensor] = None,
                R_global: Optional[torch.Tensor] = None, multiview: bool = False):
        """
        Args:
            x: (N, J, H, W) heatmaps, or (N, C) image features.
            hand_side: (N,) or (N, 2) handedness where the net takes it.
            R_global: (V, 3, 3) per-view rotations (multiview eval).
        Returns:
            (canonical coords (N, J, 3), rotation (N, 3, 3), normed coords,
            global coords), the trailing ones None where the task has none.
        """
        task = self.cfg.DATASETS.TASK
        N = x.shape[0]
        if (hand_side is not None) != self.hand_side:
            raise ValueError(f"this LiftingNet was built {'with' if self.hand_side else 'without'}"
                             " the hand-side input, but the batch "
                             f"{'lacks' if hand_side is None else 'has'} one")
        side_feat = None
        if hand_side is not None:
            side = hand_side.reshape(N, -1)[:, :1].to(x.dtype)
            side_feat = torch.cat([1.0 - side, side], dim=1)

        def with_side(t):
            return t if side_feat is None else torch.cat([t, side_feat], dim=1)

        if self.image_features:
            flat = with_side(x)
            coords = self.poseprior(flat).reshape(N, -1, 3)
            y = self.viewpoint(flat)
        else:
            x = F.avg_pool2d(x, self.pool, self.pool)  # floored windows, as flax VALID
            coords = self.poseprior(with_side(self.conv1(x).flatten(1))).reshape(N, -1, 3)
            if self.direct:
                return coords, None, None, None
            y = self.viewpoint(with_side(self.conv2(x).flatten(1)))

        trafo = rodrigues(y)
        if self.cfg.LIFTING.FLIP_ON and hand_side is not None:
            can_flip = flip_right_hand(coords, hand_side.reshape(N, -1)[:, 0])
        else:
            can_flip = coords
        normed = can_flip @ trafo
        if multiview and R_global is not None:
            return coords, trafo, normed, multiview_to_global(normed, R_global)
        return coords, trafo, normed, None
