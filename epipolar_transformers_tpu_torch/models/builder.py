"""Task-level model builder (PyTorch).

Port of the `multiview_keypoint` task of epipolar_transformers_tpu/
models/builder.py (reference modeling/model.py:25-493): an epipolar
backbone `reference` (PoseResNet or hourglass) on the target view and its
sibling `backbone` on the other view (the same module under
EPIPOLAR.SHARE_WEIGHTS), then the heatmap head and the soft-argmax decode.
The sibling's `features` feed the reference's fusion: one map for a
PoseResNet (its `trunk_features`), a tuple with one map per merge point for
an hourglass (its forward without the decode).  At eval with shared
weights, the late merge, running-stat BN and a backbone with
`trunk_features`, both views go through ONE 2N-batch trunk call, which is
numerically the two passes; the hourglass runs two.
`forward(inputs, bn_train=True)` in eval mode is TEST.TRAIN_BN (the JAX
builder's `bn_train`): the eval outputs, with every BatchNorm on batch
statistics and its running ones untouched; the trunks then run as two
passes, each view set normalized by its own statistics, as in the JAX
package.

Inputs are NCHW tensors.  In eval mode the forward returns the output
dict: heatmap_pred (N, J, H, W), batch_locs (N, J, 2), score_pred (N, J),
corr_pos (N, H, W, 2) and depth (N, K, H, W).  In training mode it returns
what the JAX builder returns with is_train=True: (loss_dict, metric_dict,
out), with the total under loss_dict['loss'].  Training runs the two views
as two passes (sibling on the other view first, then the reference, so
that shared BN statistics move twice, as in flax), with batch-statistics
BN and no peak decode.  With EPIPOLAR.REPROJECT_LOSS_WEIGHT the loss gains
`reproject_loss` (JAX models/builder.py:162-191, ops/epipolar_reproject.py)
on a PoseResNet.  The inputs' `camera` and `other_camera` reach the fusion
(the learned prior), and `other_img` the hourglass (FIND_CORR 'rgb').
MULTITEST (ROADMAP A11b) and the other tasks (ROADMAP A11c) raise.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn

from ..config import Config
from ..losses.heatmap_loss import compute_stage_loss, joints_mse_loss, keypoints_mse_smooth_loss
from ..ops.epipolar_reproject import gt_grid, reproject_consistency, reprojection_loss
from .layers import BatchNorm2d
from .registry import build_backbone


class ModelBuilder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        if cfg.DATASETS.TASK != "multiview_keypoint":
            raise NotImplementedError(
                f"DATASETS.TASK={cfg.DATASETS.TASK!r} is ROADMAP A11c (the port "
                "has multiview_keypoint)")
        self.reference = build_backbone(cfg)
        if not cfg.EPIPOLAR.SHARE_WEIGHTS:
            # an epipolarHG* body keeps its name (JAX models/builder.py:47)
            single = cfg.BACKBONE.BODY.replace("epipolarpose", "pose")
            self.backbone = build_backbone(
                cfg.replace(BACKBONE=cfg.BACKBONE.replace(BODY=single)), single_view=True)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial weights, drawn from `generator`."""
        self.reference.init_weights(generator)
        if not self.cfg.EPIPOLAR.SHARE_WEIGHTS:
            self.backbone.init_weights(generator)

    @property
    def sibling(self) -> nn.Module:
        """The other view's backbone (the reference itself when shared)."""
        return self.reference if self.cfg.EPIPOLAR.SHARE_WEIGHTS else self.backbone

    def _can_fuse_trunks(self, bn_train: bool = False) -> bool:
        """The 2N-batch trunk is the two passes when they are one function:
        shared weights, late merge and BN on running statistics."""
        c = self.cfg
        return (not self.training and not bn_train and c.EPIPOLAR.SHARE_WEIGHTS
                and c.EPIPOLAR.MERGE == "late" and not c.EPIPOLAR.WARPEDHEATMAP
                and hasattr(self.reference, "trunk_features"))

    def _other_features(self, other_img):
        """The sibling's features of the other view, detached unless
        EPIPOLAR.OTHER_GRAD: a PoseResNet's trunk (its deconv output), an
        hourglass's per-merge-point tuple from its forward."""
        sibling = self.sibling
        if hasattr(sibling, "trunk_features"):
            features = sibling.trunk_features(other_img)
            return features if self.cfg.EPIPOLAR.OTHER_GRAD else features.detach()
        features = sibling(other_img, decode_peaks=False).features
        return features if self.cfg.EPIPOLAR.OTHER_GRAD else tuple(f.detach() for f in features)

    @contextlib.contextmanager
    def _bn_batch_stats(self, on: bool):
        """Every BatchNorm on batch statistics (`on`) for the call."""
        bns = [m for m in self.modules() if isinstance(m, BatchNorm2d)] if on else []
        for m in bns:
            m.batch_stats = True
        try:
            yield
        finally:
            for m in bns:
                del m.batch_stats

    def _heatmap_loss(self, heatmaps, scoremap, vis) -> Dict[str, torch.Tensor]:
        """The loss keyed by KEYPOINT.LOSS (JAX builder `_heatmap_loss`)."""
        k = self.cfg.KEYPOINT
        if k.LOSS == "joint":
            return {"stage_loss0": joints_mse_loss(heatmaps[0], scoremap, vis,
                                                   per_joint_sum=k.LOSS_PER_JOINT)}
        if k.LOSS == "smoothmse":
            return {"stage_loss0": keypoints_mse_smooth_loss(heatmaps[0], scoremap, vis)}
        _, stage_losses = compute_stage_loss(heatmaps, scoremap)
        return {f"stage_loss{i}": v for i, v in enumerate(stage_losses)}

    def _reproject_loss(self, bb, other_features, inputs) -> torch.Tensor:
        """EPIPOLAR.REPROJECT_LOSS_WEIGHT x the masked MSE of the attention's
        round trip to the other view and back (JAX models/builder.py:162-191)."""
        if isinstance(bb.features, tuple):
            raise NotImplementedError("the reprojection loss takes a PoseResNet's single "
                                      "feature map, as in the JAX package")
        sampler = self.reference.epipolar_sampler
        geom = sampler.geometry

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        reproj, mask = reproject_consistency(
            nhwc(bb.features), nhwc(other_features), bb.sample_locs, bb.depth,
            inputs["KRT"].float(), inputs["other_KRT"].float(), geom, sampler.attention_params)
        grid = torch.as_tensor(gt_grid(geom), device=reproj.device)
        return self.cfg.EPIPOLAR.REPROJECT_LOSS_WEIGHT * reprojection_loss(reproj, grid[None],
                                                                           mask)

    def _reference(self, inputs, other_features, decode_peaks: bool):
        """The reference backbone on the target view, fused with the other's."""
        return self.reference(inputs["img"], other_features=other_features,
                              other_KRT=inputs["other_KRT"], KRT=inputs["KRT"],
                              camera=inputs.get("camera"),
                              other_camera=inputs.get("other_camera"),
                              other_img=inputs["other_img"], decode_peaks=decode_peaks)

    def _train_forward(self, inputs: Dict[str, torch.Tensor]):
        c = self.cfg
        other_features = self._other_features(inputs["other_img"])
        bb = self._reference(inputs, other_features, decode_peaks=False)
        loss_dict = {}
        if "heatmap" in inputs:
            loss_dict = self._heatmap_loss(bb.heatmaps, inputs["heatmap"],
                                           inputs.get("visibility"))
        if (c.EPIPOLAR.REPROJECT_LOSS_WEIGHT != 0 and bb.depth is not None
                and bb.sample_locs is not None):
            loss_dict["reproject_loss"] = self._reproject_loss(bb, other_features, inputs)
        out = {"heatmap_pred": bb.heatmaps[-1]}
        if bb.corr_pos is not None:
            out["corr_pos"] = bb.corr_pos
            out["depth"] = bb.depth
        # total loss (reference model.py:478-484)
        if len(loss_dict) > 1:
            loss_dict["loss"] = sum(loss_dict.values())
        elif len(loss_dict) == 1:
            loss_dict = {"loss": next(iter(loss_dict.values()))}
        return loss_dict, {}, out

    def forward(self, inputs: Dict[str, torch.Tensor], bn_train: bool = False):
        """
        Args (inputs dict): img, other_img (N, 3, H, W); KRT, other_KRT
            (N, 3, 4); camera, other_camera (N,) where EPIPOLAR.PRIOR reads
            them; in training also heatmap (N, J, h, w) and visibility
            (N, J).  bn_train: in eval mode, BatchNorm on batch statistics
            (TEST.TRAIN_BN).
        Returns the eval output dict, or in training (loss_dict,
        metric_dict, out).
        """
        c = self.cfg
        if self.training:
            return self._train_forward(inputs)
        if c.EPIPOLAR.MULTITEST:
            raise NotImplementedError("EPIPOLAR.MULTITEST is ROADMAP A11b")
        with self._bn_batch_stats(bn_train):
            return self._eval_forward(inputs, bn_train)

    def _eval_forward(self, inputs: Dict[str, torch.Tensor], bn_train: bool):
        c = self.cfg
        if self._can_fuse_trunks(bn_train):
            both = torch.cat([inputs["img"], inputs["other_img"]], dim=0)
            feat_ref, other_features = self.reference.trunk_features(both).chunk(2, dim=0)
            bb = self.reference.head_from_features(
                feat_ref, other_features=other_features,
                other_KRT=inputs["other_KRT"], KRT=inputs["KRT"], camera=inputs.get("camera"),
                other_camera=inputs.get("other_camera"))
        else:
            bb = self._reference(inputs, self._other_features(inputs["other_img"]),
                                 decode_peaks=True)
        out = {"heatmap_pred": bb.heatmaps[-1], "batch_locs": bb.locs,
               "score_pred": bb.scores}
        if bb.corr_pos is not None:
            out["corr_pos"] = bb.corr_pos
            out["depth"] = bb.depth
        if bb.sample_locs is not None and c.VIS.EPIPOLAR_LINE:
            out["sample_locs"] = bb.sample_locs
        return out
