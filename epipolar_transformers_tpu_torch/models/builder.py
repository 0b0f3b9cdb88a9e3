"""Task-level model builder (PyTorch).

Port of epipolar_transformers_tpu/models/builder.py (reference
modeling/model.py:25-493), every task of it:
  * `multiview_keypoint`: an epipolar backbone `reference` (PoseResNet or
    hourglass) on the target view and its sibling `backbone` on the other
    view (the same module under EPIPOLAR.SHARE_WEIGHTS), then the heatmap
    head and the soft-argmax decode;
  * `keypoint`: the single-view backbone and its heatmap loss;
  * the lifting tasks, LiftingNet (models/lifting.py) with the masked xyz
    loss (+ the rotation loss for *_rot) and the EPEmean metrics:
    `lifting`/`lifting_direct`/`lifting_rot` on the ground-truth heatmaps,
    `keypoint_lifting_rot` on them with pool 2 (its backbone is never
    called, so, as flax creates no parameters for it, it is not built),
    `keypoint_lifting_direct` on the backbone's heatmaps with its BN on
    running statistics even in training (`train()` keeps that backbone in
    eval mode; gradients still flow), `img_lifting_rot` on the classifier
    ResNet's pooled features, and `multiview_img_lifting_rot` on the
    epipolar fusion's heatmaps (the sibling runs the other view under
    no-grad, unconditionally, its BN moving first).
The sibling's `features` feed the reference's fusion, from its
`trunk_features`: one map for a PoseResNet, a tuple with one map per merge
point for an hourglass.  At eval with shared weights, the late merge,
running-stat BN and a backbone with `head_from_features` (a PoseResNet),
both views of `multiview_keypoint` go through ONE
2N-batch trunk call, which is numerically the two passes; the hourglass
runs two.  `forward(inputs, bn_train=True)` in eval mode is TEST.TRAIN_BN
(the JAX builder's `bn_train`): the eval outputs, with every BatchNorm on
batch statistics and its running ones untouched; the trunks then run as
two passes, each view set normalized by its own statistics, as in the JAX
package.

Inputs are NCHW tensors.  For `multiview_keypoint` and `keypoint` in eval
mode the forward returns the output dict: heatmap_pred (N, J, H, W),
batch_locs (N, J, 2), score_pred (N, J), and for the multiview task
corr_pos (N, H, W, 2) and depth (N, K, H, W).  In training mode, and for
the lifting tasks in both modes, it returns what the JAX builder returns:
(loss_dict, metric_dict, out), with the total under loss_dict['loss'].
Training runs the two views as two passes (sibling on the other view
first, then the reference, so that shared BN statistics move twice, as in
flax), with batch-statistics BN and no peak decode.  With
EPIPOLAR.REPROJECT_LOSS_WEIGHT the loss gains `reproject_loss` (JAX
models/builder.py:162-191, ops/epipolar_reproject.py) on a PoseResNet.
The inputs' `camera` and `other_camera` reach the fusion (the learned
prior), and `other_img` the hourglass (FIND_CORR 'rgb').  The lifting
tasks take the hand-side one-hot where DATASET_FAMILY is 'rhd'.
EPIPOLAR.MULTITEST at eval runs the target view against each of several
candidate other views and keeps, per joint, the most confident peak (JAX
`_multitest_forward`, models/builder.py:336-371).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn

from ..config import Config
from ..losses.heatmap_loss import compute_stage_loss, joints_mse_loss, keypoints_mse_smooth_loss
from ..metrics.metrics3d import epe_mean, epe_mean_multiview_gt
from ..ops.epipolar_reproject import gt_grid_on, reproject_consistency, reprojection_loss
from ..utils import tracing
from .layers import BatchNorm2d
from .lifting import LiftingNet
from .registry import build_backbone

MULTIVIEW_TASKS = ("multiview_keypoint", "multiview_img_lifting_rot")
SINGLE_VIEW_TASKS = ("keypoint", "keypoint_lifting_rot", "keypoint_lifting_direct")


def _total(loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The total loss under 'loss' (reference model.py:478-484)."""
    if len(loss_dict) > 1:
        return {**loss_dict, "loss": sum(loss_dict.values())}
    if len(loss_dict) == 1:
        return {"loss": next(iter(loss_dict.values()))}
    return loss_dict


class ModelBuilder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        task = cfg.DATASETS.TASK
        # the hand-side one-hot: RHD's items carry it (the config loader
        # infers DATASET_FAMILY from the dataset names)
        side = cfg.DATASET_FAMILY == "rhd"
        if task in MULTIVIEW_TASKS:
            self.reference = build_backbone(cfg)
            if not cfg.EPIPOLAR.SHARE_WEIGHTS:
                # an epipolarHG* body keeps its name (JAX models/builder.py:47)
                single = cfg.BACKBONE.BODY.replace("epipolarpose", "pose")
                self.backbone = build_backbone(
                    cfg.replace(BACKBONE=cfg.BACKBONE.replace(BODY=single)), single_view=True)
            if task == "multiview_img_lifting_rot":
                self.liftingnet = LiftingNet(cfg, hand_side=side)
        elif task in SINGLE_VIEW_TASKS:
            if task != "keypoint_lifting_rot":  # never called there: no parameters in flax
                self.backbone = build_backbone(cfg, single_view=True)
            if task != "keypoint":
                self.liftingnet = LiftingNet(cfg, hand_side=side)
        elif task == "img_lifting_rot":
            self.backbone = build_backbone(cfg, single_view=True)
            self.liftingnet = LiftingNet(cfg, in_features=self.backbone.out_channels,
                                         hand_side=side)
        elif cfg.LIFTING.ENABLED:
            self.liftingnet = LiftingNet(cfg, hand_side=side)
        else:
            raise NotImplementedError(f"DATASETS.TASK={task!r}")
        self.train()

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initial weights, drawn from `generator`."""
        for name in ("reference", "backbone", "liftingnet"):
            if name in self._modules:
                self._modules[name].init_weights(generator)

    def seed_dropout(self, seed: int) -> None:
        """Restart the lifting net's dropout masks from `seed`."""
        if "liftingnet" in self._modules:
            self.liftingnet.seed_dropout(seed)

    def train(self, mode: bool = True):
        """As nn.Module.train, except that `keypoint_lifting_direct` keeps
        its backbone in eval mode: BN on running statistics even in
        training (JAX models/builder.py:214-216)."""
        super().train(mode)
        if self.cfg.DATASETS.TASK == "keypoint_lifting_direct":
            self.backbone.eval()
        return self

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
                and hasattr(self.reference, "head_from_features"))

    def _other_features(self, other_img, grad: bool):
        """The sibling's features of the other view, detached unless `grad`:
        a PoseResNet's trunk (its deconv output), an hourglass's
        per-merge-point tuple."""
        with tracing.span("model.other_trunk"), \
                torch.set_grad_enabled(bool(grad) and torch.is_grad_enabled()):
            return self.sibling.trunk_features(other_img)

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
        with tracing.span("model.loss"):
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
        return self.cfg.EPIPOLAR.REPROJECT_LOSS_WEIGHT * reprojection_loss(
            reproj, gt_grid_on(geom, reproj.device)[None], mask)

    def _reference(self, inputs, other_features, decode_peaks: bool):
        """The reference backbone on the target view, fused with the other's."""
        with tracing.span("model.reference"):
            return self.reference(inputs["img"], other_features=other_features,
                                  other_KRT=inputs["other_KRT"], KRT=inputs["KRT"],
                                  camera=inputs.get("camera"),
                                  other_camera=inputs.get("other_camera"),
                                  other_img=inputs["other_img"], decode_peaks=decode_peaks)

    def _train_forward(self, inputs: Dict[str, torch.Tensor]):
        c = self.cfg
        other_features = self._other_features(inputs["other_img"], c.EPIPOLAR.OTHER_GRAD)
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
        return _total(loss_dict), {}, out

    def forward(self, inputs: Dict[str, torch.Tensor], bn_train: bool = False):
        """
        Args (inputs dict): img, other_img (N, 3, H, W); KRT, other_KRT
            (N, 3, 4); camera, other_camera (N,) where EPIPOLAR.PRIOR reads
            them; in training also heatmap (N, J, h, w) and visibility
            (N, J); the lifting tasks' can-points-3d, normed-points-3d
            (N, J, 3), rotation (N, 3, 3), hand-side, scale, unit (N,), and
            under VIS.MULTIVIEW at eval R (V, 3, 3) and points-3d.
            bn_train: in eval mode, BatchNorm on batch statistics
            (TEST.TRAIN_BN).
        Returns the eval output dict, or (loss_dict, metric_dict, out) in
        training and for the lifting tasks.
        """
        c = self.cfg
        task = c.DATASETS.TASK
        if task not in ("keypoint", "multiview_keypoint"):
            return self._lifting_forward(inputs)
        if task == "keypoint":
            return self._keypoint_forward(inputs, bn_train)
        if self.training:
            return self._train_forward(inputs)
        if c.EPIPOLAR.MULTITEST:
            return self._multitest_forward(inputs)
        with self._bn_batch_stats(bn_train):
            return self._eval_forward(inputs, bn_train)

    def _multitest_forward(self, inputs: Dict[str, torch.Tensor]):
        """MULTITEST eval (reference model.py:213-239): `other_img` (O, N, 3,
        H, W) and `other_KRT` (O, N, 3, 4) carry O candidate views; the
        target view runs against each, and each joint keeps the location
        and score of its most confident candidate (the first on a tie).  The
        heatmaps are the last candidate's.  As in the JAX package, the
        cameras do not reach the fusion."""
        locs, scores = [], []
        for other_img, other_KRT in zip(inputs["other_img"], inputs["other_KRT"]):
            bb = self.reference(inputs["img"],
                                other_features=self._other_features(other_img, False),
                                other_KRT=other_KRT, KRT=inputs["KRT"], other_img=other_img,
                                decode_peaks=True)
            locs.append(bb.locs)
            scores.append(bb.scores)
        scores = torch.stack(scores)  # (O, N, J)
        best_score, best = scores.max(dim=0)
        best_locs = torch.gather(torch.stack(locs), 0,
                                 best[None, ..., None].expand(1, *best.shape, 2))[0]
        return {"heatmap_pred": bb.heatmaps[-1], "batch_locs": best_locs,
                "score_pred": best_score}

    def _keypoint_forward(self, inputs: Dict[str, torch.Tensor], bn_train: bool):
        """The single-view task: the backbone on `img`; its heatmap loss in
        training, the decoded peaks at eval."""
        if self.training:
            bb = self.backbone(inputs["img"], decode_peaks=False)
            loss_dict = {}
            if "heatmap" in inputs:
                loss_dict = self._heatmap_loss(bb.heatmaps, inputs["heatmap"],
                                               inputs.get("visibility"))
            return _total(loss_dict), {}, {"heatmap_pred": bb.heatmaps[-1]}
        with self._bn_batch_stats(bn_train):
            bb = self.backbone(inputs["img"], decode_peaks=True)
        return {"heatmap_pred": bb.heatmaps[-1], "batch_locs": bb.locs, "score_pred": bb.scores}

    def _lifting_features(self, inputs: Dict[str, torch.Tensor]):
        """What LiftingNet lifts, by task, and the fusion's output where
        the task fuses (else None)."""
        task = self.cfg.DATASETS.TASK
        if task == "keypoint_lifting_direct":
            return self.backbone(inputs["img"], decode_peaks=False).heatmaps[-1], None
        if task == "multiview_img_lifting_rot":
            # no OTHER_GRAD check for this task (JAX models/builder.py:217-240)
            other_features = self._other_features(inputs["other_img"], False)
            fused = self._reference(inputs, other_features, decode_peaks=not self.training)
            return fused.heatmaps[-1], fused
        if task == "img_lifting_rot":
            return self.backbone(inputs["img"]), None
        return inputs["heatmap"], None

    def _lifting_forward(self, inputs: Dict[str, torch.Tensor]):
        """The lifting tasks (JAX models/builder.py:203-334): LiftingNet, the
        masked xyz loss, the rotation loss and EPEmean for *_rot, and under
        VIS.MULTIVIEW at eval the global-frame fusion."""
        c = self.cfg
        task = c.DATASETS.TASK
        feat, fused = self._lifting_features(inputs)
        feat = feat.to(torch.promote_types(feat.dtype, torch.float32))
        coords, R, normed, global_pred = self.liftingnet(
            feat, inputs.get("hand-side"), inputs.get("R"),
            multiview=not self.training and c.VIS.MULTIVIEW)
        dtype = coords.dtype
        target = inputs["normed-points-3d" if task in ("lifting_direct", "keypoint_lifting_direct")
                        else "can-points-3d"].to(dtype)
        out = {"can_pred": coords}
        if fused is not None:
            out["heatmap_pred"] = fused.heatmaps[-1]
            if fused.locs is not None:
                out["batch_locs"] = fused.locs
                out["score_pred"] = fused.scores
        if R is not None:
            out["R_pred"] = R
            out["normed_pred"] = normed

        vis = inputs["visibility"]
        while vis.ndim > 2:
            vis = vis[..., 0]
        vis_mask = vis.to(dtype)[..., None]
        sq = (coords * vis_mask - target * vis_mask) ** 2
        loss_dict = {"xyz_loss": sq.mean() if c.LIFTING.AVELOSS_KP else sq.sum() / coords.shape[0]}
        if "lifting_rot" in task:
            loss_dict["rot_loss"] = torch.mean((R - inputs["rotation"].to(dtype)) ** 2)
        with torch.no_grad():
            metric_dict = self._lifting_metrics(inputs, coords, target, normed, global_pred, vis)
        return _total(loss_dict), metric_dict, out

    def _lifting_metrics(self, inputs, coords, target, normed, global_pred, vis):
        """EPEmean_can, EPEmean (*_rot) and EPEmean_global (the VIS.MULTIVIEW
        fusion at eval, reference model.py:461-476)."""
        c = self.cfg
        scale, unit = inputs.get("scale"), inputs.get("unit")
        max_dist = c.TEST.EPEMEAN_MAX_DIST
        metric_dict = {"EPEmean_can": epe_mean(coords, target, vis, scale, unit,
                                               max_dist=max_dist)[0]}
        if "lifting_rot" not in c.DATASETS.TASK:
            return metric_dict
        normed_target = inputs["normed-points-3d"].to(coords.dtype)
        metric_dict["EPEmean"] = epe_mean(normed, normed_target, vis, scale, unit,
                                          max_dist=max_dist)[0]
        if (self.training or global_pred is None or "points-3d" not in inputs
                or target.shape[1] >= 100):
            return metric_dict
        # under the VIS.MULTIVIEW squeeze the batch axis is the view axis of
        # ONE sample: targets and predictions relative to the root joint and
        # to view 0's prediction, fused by the mean or the LOWER median over
        # the views (torch .median(0)), or bounded by the nearest view
        unit0 = unit[0] if unit is not None and unit.ndim >= 1 else unit
        kp_scale = scale[:, None, None].to(coords.dtype) if scale is not None else 1.0
        tg = inputs["points-3d"][0].to(coords.dtype)
        tg = tg - tg[0]
        gp = (global_pred - global_pred[0]) * kp_scale
        if c.LIFTING.MULTIVIEW_UPPERBOUND:
            metric_dict["EPEmean_global"] = epe_mean_multiview_gt(
                gp, tg, vis, unit=unit0 if unit0 is not None else 1.0)
            return metric_dict
        V = gp.shape[0]
        fused = gp.sort(dim=0).values[(V - 1) // 2] if c.LIFTING.MULTIVIEW_MEDIUM else gp.mean(0)
        metric_dict["EPEmean_global"] = epe_mean(fused, tg, vis[0], unit=unit0,
                                                 max_dist=max_dist)[0]
        return metric_dict

    def _eval_forward(self, inputs: Dict[str, torch.Tensor], bn_train: bool):
        c = self.cfg
        if self._can_fuse_trunks(bn_train):
            with tracing.span("model.trunks"):
                both = torch.cat([inputs["img"], inputs["other_img"]], dim=0)
                feat_ref, other_features = self.reference.trunk_features(both).chunk(2, dim=0)
            with tracing.span("model.reference"):
                bb = self.reference.head_from_features(
                    feat_ref, other_features=other_features,
                    other_KRT=inputs["other_KRT"], KRT=inputs["KRT"],
                    camera=inputs.get("camera"), other_camera=inputs.get("other_camera"))
        else:
            bb = self._reference(inputs, self._other_features(inputs["other_img"], False),
                                 decode_peaks=True)
        out = {"heatmap_pred": bb.heatmaps[-1], "batch_locs": bb.locs,
               "score_pred": bb.scores}
        if bb.corr_pos is not None:
            out["corr_pos"] = bb.corr_pos
            out["depth"] = bb.depth
        if bb.sample_locs is not None and c.VIS.EPIPOLAR_LINE:
            out["sample_locs"] = bb.sample_locs
        return out
