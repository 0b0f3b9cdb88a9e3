"""Backbone registry (reference modeling/registry.py:5 + resnet.py:495-519).

Maps BACKBONE.BODY names to module constructors taking the config and
`single_view` (a sibling that never fuses holds no fusion layer): the
PoseResNet family and the eight hourglass bodies of the JAX registry
(epipolar_transformers_tpu/models/registry.py:35-37), and the classifier
ResNet (`R-*`) of `img_lifting_rot`.
"""

from __future__ import annotations

from .hourglass import HG_BODIES, HourglassNet
from .resnet import RESNET_SPEC, PoseResNet, ResNet

BACKBONES = {}
for _depth in RESNET_SPEC:
    BACKBONES[f"R-{_depth}"] = ResNet
    BACKBONES[f"poseR-{_depth}"] = PoseResNet
    BACKBONES[f"epipolarposeR-{_depth}"] = PoseResNet
for _body in HG_BODIES:
    BACKBONES[_body] = HourglassNet


def build_backbone(cfg, single_view: bool = False):
    """The backbone of cfg.BACKBONE.BODY; `single_view` builds one that is
    only ever run on one view (a sibling under unshared weights), which
    holds no fusion layer."""
    body = cfg.BACKBONE.BODY
    if body not in BACKBONES:
        raise NotImplementedError(
            f"BACKBONE.BODY={body!r}: the port has {sorted(BACKBONES)}")
    return BACKBONES[body](cfg, single_view=single_view)
