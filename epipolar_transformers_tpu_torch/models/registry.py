"""Backbone registry (reference modeling/registry.py:5 + resnet.py:495-519).

Maps BACKBONE.BODY names to module constructors taking the config.  The
port has the PoseResNet family; the classifier ResNet and the hourglass
nets are ROADMAP A11.
"""

from __future__ import annotations

from .resnet import RESNET_SPEC, PoseResNet

BACKBONES = {}
for _depth in RESNET_SPEC:
    BACKBONES[f"poseR-{_depth}"] = PoseResNet
    BACKBONES[f"epipolarposeR-{_depth}"] = PoseResNet


def build_backbone(cfg):
    body = cfg.BACKBONE.BODY
    if body not in BACKBONES:
        raise NotImplementedError(
            f"BACKBONE.BODY={body!r}: the port has {sorted(BACKBONES)}; "
            "the others are ROADMAP A11")
    return BACKBONES[body](cfg)
