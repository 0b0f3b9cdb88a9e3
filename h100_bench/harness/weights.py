"""Random weights from the seed, made on the device in one draw.

Every floating tensor of the reference's state comes out of one normal draw
of a `torch.Generator` on the device, sliced and scaled by name:

- a convolution: He scaling, N(0, 2 / fan-in), where fan-in is what one
  output sums over (a 4x4 stride-2 transposed convolution: in x 4); the
  heatmap head and the fusion's `z`, which no ReLU follows, N(0, 1 / fan-in);
- a convolution's bias: N(0, 0.01^2);
- a BatchNorm's scale 1 + 0.1 N, its shift 0.05 N; the scale of the last BN
  of each residual branch (`bn3`, and the fusion's `bn`) 0.25 + 0.05 N, so
  that the residual stream grows slowly through 50 or 152 layers when BN
  runs on its running statistics (0 and 1);
- nothing else is drawn.

BasicBlock trunks (R-18, R-34, the CPU tests' sizes) scale their `bn2` as any other.

The defaults name the flagship's layers; a reference module whose layers
need others gives them as its `weight_rules`.  The same dict goes to the
program and to the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

SCALED_BRANCH_BN = ("bn3.weight", "epipolar_sampler.bn.weight")
NO_RELU_AFTER = ("final_layer.weight", "epipolar_sampler.z.weight")
TRANSPOSED = "deconv_layers"  # the head's transposed convolutions


def _scale(name: str, shape: tuple, transposed: bool, no_relu_after: Tuple[str, ...],
           scaled_branch_bn: Tuple[str, ...]):
    """(multiplier, offset) of the draw for `name`."""
    if name.endswith("running_mean"):
        return 0.0, 0.0
    if name.endswith("running_var"):
        return 0.0, 1.0
    if len(shape) == 4:
        fan = (shape[0] * shape[2] * shape[3] // 4) if transposed else \
            shape[1] * shape[2] * shape[3]
        gain = 1.0 if name.endswith(no_relu_after) else 2.0
        return (gain / fan) ** 0.5, 0.0
    if name.endswith(scaled_branch_bn):
        return 0.05, 0.25
    if ".bn" in name or name.startswith("bn") or "downsample.1" in name or \
            "deconv_layers" in name:
        return (0.1, 1.0) if name.endswith("weight") else (0.05, 0.0)
    return 0.01, 0.0  # a convolution's bias


def make_state(shapes: Dict[str, tuple], seed: int, device,
               no_relu_after: Tuple[str, ...] = NO_RELU_AFTER,
               scaled_branch_bn: Tuple[str, ...] = SCALED_BRANCH_BN) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every name in `shapes`; the
    convolutions whose names end in `no_relu_after` take the gain 1, the
    BNs whose scales end in `scaled_branch_bn` the small scale."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    state, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mult, offset = _scale(name, shape, name.startswith(TRANSPOSED) and len(shape) == 4,
                              no_relu_after, scaled_branch_bn)
        state[name] = draw[at:at + n].view(shape) * mult + offset
        at += n
    return state

