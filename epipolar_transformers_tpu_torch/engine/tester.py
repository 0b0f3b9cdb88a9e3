"""Evaluation engine (PyTorch): the eval forward on the model's device, then
triangulation to 3D and the metrics on the host.

Port of epipolar_transformers_tpu/engine/tester.py (reference
engine/tester.py:21-227).  Per multiview group, the fused multiview forward
runs on the device and decodes the peaks; the host triangulates them in
float64 in one of six modes (naive, refine, pymvg, epipolar, epipolar_dlt,
rpsm, whose unary term samples the heatmaps on the model's device) and
accumulates MPJPE (global and per action, clamped at
TEST.EPEMEAN_MAX_DIST), JDR and PCK, averaged over the groups.  Also the
VIS.SAVE_PRED pickles, TEST.TRAIN_BN (BatchNorm on batch statistics at
eval) and TEST.RECOMPUTE_BN (the running statistics re-estimated over the
eval groups before the test, and restored after it, as the JAX `test`
leaves its caller's state as it was).

Test batches are (B, V, ...) view groups of TEST.IMS_PER_BATCH; as in the
JAX package, each batch's first group is evaluated and its V views become
the device batch.

The drive is double-buffered: the copies of group n's outputs to pinned host
buffers are queued behind its forward with one event, group n+1's forward
is queued, and only then does the host wait for that event and triangulate
group n while the device runs group n+1.  A serial drive
(`double_buffer=False`) gives the same results bit for bit.

The lifting tasks (LIFTING.ENABLED) take `_test_lifting` instead: the
model computes its own metric dict (EPEmean_can, EPEmean, EPEmean_global)
at eval, which is averaged as it is with the losses (JAX
engine/tester.py:147-211, reference tester.py:131-137); under VIS.MULTIVIEW
each (1, V, ...) batch is squeezed so that its views form the batch.  The
single-view `keypoint` task goes through the multiview eval above, with its
views as the batch; the epipolar modes need `corr_pos`, which only the
multiview task gives, and raise.

VIS.VIDEO dumps each group's views with its predicted skeletons drawn
over them (vis/visualization.py:dump_eval_frames, OUTPUT_DIR/video/ds<i>/
view<k>/%08d.png); VIS.VIDEO_GT dumps the ground-truth skeletons into
OUTPUT_DIR/video_gt/... and runs no model on those groups (JAX
engine/tester.py:213-221,243-248, reference tester.py:100-166).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import make_eval_loaders
from ..geometry.body import HumanBody, compute_limb_length
from ..geometry.host import triangulate_epipolar_np, triangulate_pymvg_np, triangulate_ransac_np
from ..geometry.pictorial import rpsm
from ..metrics.metrics2d import calculate_err, jdr
from ..utils import tracing
from ..utils.file_utils import pred_pickle_path
from ..utils.metric_logger import MetricLogger
from ..vis.visualization import dump_eval_frames

logger = logging.getLogger(__name__)

EVAL_KEYS = ("img", "KRT", "other_img", "other_KRT", "camera", "other_camera")
# what a train step also takes: the target heatmaps and joint visibility
TRAIN_KEYS = EVAL_KEYS + ("heatmap", "visibility")
# every key the model takes: those and the lifting tasks' (JAX
# select_model_inputs, engine/trainer.py:43-50)
MODEL_KEYS = TRAIN_KEYS + ("hand-side", "can-points-3d", "normed-points-3d", "rotation",
                           "scale", "unit", "R")
NHWC_KEYS = ("img", "other_img", "heatmap")

H36M_ACTIONS = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "WalkDog", "Walking", "WalkTogether",
)


def action_name(idx: int, cfg: Config) -> str:
    if cfg.is_h36m and 0 <= idx - 2 < len(H36M_ACTIONS):
        # reference maps action ids 2..16 (multiview_h36m.py:25-89)
        return H36M_ACTIONS[idx - 2]
    return f"action{idx}"


def to_model_inputs(group: Dict[str, np.ndarray], device,
                    keys=EVAL_KEYS) -> Dict[str, torch.Tensor]:
    """Host arrays -> model inputs on `device`, the `keys` the group has.
    Images and heatmaps come NHWC; permuted to NCHW they are already
    channels_last in memory, so no copy is made."""
    out = {}
    for k in (k for k in keys if k in group):
        t = torch.from_numpy(np.ascontiguousarray(group[k])).to(device, non_blocking=True)
        out[k] = t.permute(0, 3, 1, 2) if k in NHWC_KEYS else t
    return out


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_eval_step(cfg: Config, model: torch.nn.Module, device,
                   train_bn: bool = False) -> Callable:
    """Eval-mode forward over one view group (V views as the batch); with
    `train_bn`, BatchNorm on batch statistics (TEST.TRAIN_BN).  Spans
    (utils/tracing.py): `eval_step` (one id a group), `eval.upload`,
    `eval.forward`."""
    model.eval()

    def eval_step(group: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        with tracing.step("eval_step"), torch.inference_mode():
            with tracing.span("eval.upload"):
                inputs = to_model_inputs(group, device)
            with tracing.span("eval.forward"):
                return model(inputs, bn_train=train_bn)

    return eval_step


def predict(cfg: Config, model: torch.nn.Module, loader: Iterable,
            max_batches: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """Run the eval forward over `loader`'s view groups on the model's
    device; returns one output dict per group, left on the device (the
    caller decides when to sync)."""
    eval_step = make_eval_step(cfg, model, _device_of(model))
    outputs = []
    for ib, batch in enumerate(loader):
        if max_batches is not None and ib >= max_batches:
            break
        group = {k: v[0] for k, v in batch.items()}
        outputs.append(eval_step(group))
    return outputs


def recompute_bn(cfg: Config, model: torch.nn.Module, max_batches: Optional[int] = None) -> None:
    """TEST.RECOMPUTE_BN: move the running statistics over the eval groups
    with train-mode forwards under `torch.no_grad()` (flax's update,
    models/layers.py), the parameters untouched; up to `max_batches` groups
    of each loader.  Leaves the model in eval mode."""
    device = _device_of(model)
    model.train()
    try:
        with torch.no_grad():
            for loader in make_eval_loaders(cfg):
                for ib, batch in enumerate(loader):
                    if max_batches is not None and ib >= max_batches:
                        break
                    model(to_model_inputs({k: v[0] for k, v in batch.items()}, device))
    finally:
        model.eval()


def _triangulate(cfg: Config, group, locs, scores, out, device=None) -> np.ndarray:
    resize = cfg.DATASETS.IMAGE_RESIZE * cfg.DATASETS.PREDICT_RESIZE
    mode = cfg.KEYPOINT.TRIANGULATION
    pts = locs * resize
    if mode == "pymvg":
        return triangulate_pymvg_np(pts, group["K"], group["RT"], scores,
                                    conf_thres=cfg.KEYPOINT.CONF_THRES)
    if mode == "naive":
        return triangulate_ransac_np(pts, group["KRT"], scores,
                                     cfg.KEYPOINT.CONF_THRES, cfg.KEYPOINT.RANSAC_THRES)
    if mode == "refine":
        return triangulate_ransac_np(pts, group["KRT"], scores,
                                     cfg.KEYPOINT.CONF_THRES, cfg.KEYPOINT.RANSAC_THRES,
                                     refine=True)
    if mode in ("epipolar", "epipolar_dlt"):
        return triangulate_epipolar_np(
            pts, group["KRT"], group["K"], group["RT"], scores,
            np.asarray(out["corr_pos"], dtype=np.float64),
            group["other_KRT"],
            cfg.KEYPOINT.CONF_THRES, cfg.KEYPOINT.RANSAC_THRES,
            resize=resize, downsample=cfg.BACKBONE.DOWNSAMPLE,
            dlt=(mode == "epipolar_dlt"),
        )
    if mode == "rpsm":
        body = HumanBody()
        target = np.asarray(group["points-3d"], dtype=np.float64)
        gt0 = target[0] if target.ndim == 3 else target
        if "origK" in group:
            K, boxes = group["origK"], [{"center": c, "scale": s} for c, s in
                                        zip(group["crop_center"], group["crop_scale"])]
        else:
            # an uncropped view (the synthetic rig): its K is the original
            # one and its box the whole image (tests/test_pictorial.py's setting)
            H, W = cfg.DATASETS.IMAGE_SIZE
            K = group["K"]
            boxes = [{"center": np.array([W / 2.0, H / 2.0]),
                      "scale": np.array([W / 200.0, H / 200.0])}] * len(K)
        cams = np.asarray(K, dtype=np.float64) @ np.asarray(group["RT"], dtype=np.float64)
        p = cfg.PICT_STRUCT
        return rpsm(
            cams, out["heatmap_pred"], center=gt0[cfg.KEYPOINT.ROOTIDX], boxes=boxes, body=body,
            limb_length=compute_limb_length(body, gt0),
            img_size=tuple(cfg.DATASETS.IMAGE_SIZE),
            grid_size=p.GRID_SIZE, first_nbins=p.FIRST_NBINS,
            recur_nbins=p.RECUR_NBINS, recur_depth=p.RECUR_DEPTH,
            tolerance=p.LIMB_LENGTH_TOLERANCE, root_idx=cfg.KEYPOINT.ROOTIDX,
            device=device,
        )
    raise NotImplementedError(mode)


class EvalRecord:
    """What `process_group` accumulates over a test: the metric meters, the
    VIS.SAVE_PRED predictions and the PCK curve accumulators."""

    def __init__(self):
        self.meters = MetricLogger()
        self.predictions: List[dict] = []
        self.err_joints: List[np.ndarray] = []
        self.total_joints: List[np.ndarray] = []


def process_group(cfg: Config, group: Dict[str, np.ndarray], out: Dict[str, np.ndarray],
                  record: EvalRecord, ib: int = 0, device=None) -> Dict[str, float]:
    """The host half of one view group (the JAX tester's `process`): f64
    triangulation, MPJPE clamped at TEST.EPEMEAN_MAX_DIST, MPJPE@<action>,
    JDR and PCK, added to `record`, and the group's SAVE_PRED entry.

    out: host arrays in the port's layout, batch_locs (V, J, 2), score_pred
    (V, J), heatmap_pred (V, J, h, w) where JDR or RPSM need it, corr_pos
    (V, h, w, 2) where the epipolar modes or SAVE_PRED need it.  device:
    where RPSM's unary term runs.  Returns the group's metrics.  Runs in the
    `eval.process_group` span (utils/tracing.py)."""
    with tracing.span("eval.process_group"):
        locs = np.asarray(out["batch_locs"], dtype=np.float64)  # (V, J, 2)
        scores = np.asarray(out["score_pred"], dtype=np.float64)  # (V, J)

        metric_dict: Dict[str, float] = {}
        pred3d = None
        if cfg.KEYPOINT.TRIANGULATION and "points-3d" in group:
            pred3d = _triangulate(cfg, group, locs, scores, out, device)
            target3d = np.asarray(group["points-3d"], dtype=np.float64)
            if target3d.ndim == 3:
                target3d = target3d[0]
            err = np.linalg.norm(pred3d - target3d, axis=-1)
            err = np.minimum(err, cfg.TEST.EPEMEAN_MAX_DIST)
            mpjpe = float(err.mean())
            metric_dict["EPEmean_global"] = mpjpe
            act = int(np.asarray(group["action"]).reshape(-1)[0])
            metric_dict[f"MPJPE@{action_name(act, cfg)}"] = mpjpe

        if cfg.TEST.PCK and "heatmap" in group:
            hm_gt = np.asarray(group["heatmap"]).transpose(0, 3, 1, 2)
            _, avg_jdr, _, _ = jdr(np.asarray(out["heatmap_pred"]), hm_gt)
            metric_dict["JDR"] = float(avg_jdr)
            pcks, err_joints, total_joints = calculate_err(
                locs.transpose(0, 2, 1),
                np.asarray(group["points-2d"]).transpose(0, 2, 1),
                np.asarray(group["visibility"]),
                cfg.TEST.THRESHOLDS,
                cfg.TEST.MAX_TH,
            )
            metric_dict.update(pcks)
            record.err_joints.append(err_joints)
            record.total_joints.append(total_joints)

        record.meters.update(**metric_dict)

        if cfg.VIS.SAVE_PRED and ib % cfg.VIS.SAVE_PRED_FREQ == 0:
            if cfg.VIS.SAVE_PRED_LIMIT < 0 or len(record.predictions) < cfg.VIS.SAVE_PRED_LIMIT:
                record.predictions.append({
                    "batch_locs": locs, "score_pred": scores,
                    "pred3d": pred3d,
                    "gt3d": np.asarray(group.get("points-3d")),
                    "corr_pos": np.asarray(out["corr_pos"]) if "corr_pos" in out else None,
                })
        return metric_dict


def host_output_keys(cfg: Config, group) -> List[str]:
    """The eval outputs that `process_group` reads for this config."""
    keys = ["batch_locs", "score_pred"]
    mode = cfg.KEYPOINT.TRIANGULATION
    if mode in ("epipolar", "epipolar_dlt") or cfg.VIS.SAVE_PRED:
        keys.append("corr_pos")
    if mode == "rpsm" or (cfg.TEST.PCK and "heatmap" in group):
        keys.append("heatmap_pred")
    return keys


def fetch_outputs(out: Dict[str, torch.Tensor], keys):
    """Queue the copies of `out[keys]` (floats as float32) to the host.
    From a CUDA device they go into pinned buffers, non_blocking, with one
    event recorded behind them; returns the host tensors and that event
    (None when nothing came from a CUDA device).  Runs in the `eval.fetch`
    span (utils/tracing.py)."""
    with tracing.span("eval.fetch"):
        host, on_cuda = {}, False
        for k in keys:
            if k not in out:
                continue
            t = out[k].float() if out[k].is_floating_point() else out[k]
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t, on_cuda = buf, True
            host[k] = t
        event = None
        if on_cuda:
            event = torch.cuda.Event()
            event.record()
    return host, event


def dump_gt_frames(cfg: Config, group, tag: str, idx: int) -> None:
    """VIS.VIDEO_GT: the ground-truth skeletons over the group's views, in
    OUTPUT_DIR/video_gt (reference tester.py:100-128 draws
    batchdata['points-2d'] and runs no model)."""
    gt2d = np.asarray(group["points-2d"], dtype=np.float64)
    out_cfg = cfg.replace(OUTPUT_DIR=os.path.join(cfg.OUTPUT_DIR, "video_gt"))
    dump_eval_frames(out_cfg, group, gt2d, tag, idx)


def _check_supported(cfg: Config) -> None:
    if (cfg.DATASETS.TASK == "keypoint"
            and cfg.KEYPOINT.TRIANGULATION in ("epipolar", "epipolar_dlt")):
        # the JAX tester fails on the missing out['corr_pos'] there
        raise ValueError(f"KEYPOINT.TRIANGULATION={cfg.KEYPOINT.TRIANGULATION!r} reads the "
                         "fusion's corr_pos, which the single-view keypoint task has not")


def _test_lifting(cfg: Config, model: torch.nn.Module,
                  max_batches: Optional[int] = None) -> Dict[str, float]:
    """The lifting tasks' eval (JAX engine/tester.py:147-211): the model's
    losses and metric dict per batch, averaged; under VIS.MULTIVIEW the
    (1, V, ...) batches are squeezed so that the views form the batch, and
    `points-3d` goes in; VIS.SAVE_PRED writes per-sample (inputs, outputs)
    pairs, the outputs in the port's layout."""
    device = _device_of(model)
    keys = MODEL_KEYS + (("points-3d",) if cfg.VIS.MULTIVIEW else ())
    meters = MetricLogger()
    predictions = []
    model.eval()
    for loader in make_eval_loaders(cfg):
        for ib, batch in enumerate(loader):
            if max_batches is not None and ib >= max_batches:
                break
            if cfg.VIS.MULTIVIEW:
                batch = {k: v[0] if np.ndim(v) > 0 and np.shape(v)[0] == 1 else v
                         for k, v in batch.items()}
            with torch.inference_mode():
                loss_dict, metric_dict, out = model(to_model_inputs(batch, device, keys))
            meters.update(**{k: float(v) for k, v in {**loss_dict, **metric_dict}.items()})
            if cfg.VIS.SAVE_PRED and ib % cfg.VIS.SAVE_PRED_FREQ == 0:
                host_batch = {k: np.asarray(v) for k, v in batch.items() if np.ndim(v) > 0}
                host_out = {k: v.float().cpu().numpy() if v.is_floating_point() else
                            v.cpu().numpy() for k, v in out.items()}
                for i in range(host_batch["visibility"].shape[0]):
                    if 0 <= cfg.VIS.SAVE_PRED_LIMIT <= len(predictions):
                        break
                    predictions.append(({k: v[i] for k, v in host_batch.items()},
                                        {k: v[i] for k, v in host_out.items()}))

    if cfg.VIS.SAVE_PRED and predictions and cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        path = pred_pickle_path(cfg, cfg.OUTPUT_DIR)
        with open(path, "wb") as f:
            pickle.dump(predictions, f)
        logger.info("saved %d lifting predictions to %s", len(predictions), path)
    results = meters.get_all_avg()
    logger.info("eval: %s", results)
    return results


def test(cfg: Config, model: torch.nn.Module, max_batches: Optional[int] = None,
         double_buffer: bool = True) -> Dict[str, float]:
    """Run the evaluation on the model's device; returns the averaged
    metrics (reference tester.py:216-227).  The model's running statistics
    and train/eval mode are as they were when it returns.

    Args:
        max_batches: evaluate at most this many batches of each loader.
        double_buffer: overlap group n's host half with group n+1's forward
            (False: one group after another; the results are the same).
    """
    _check_supported(cfg)
    was_training = model.training
    saved = ([b.clone() for b in model.buffers()]
             if cfg.TEST.RECOMPUTE_BN and not cfg.LIFTING.ENABLED else None)
    try:
        if cfg.LIFTING.ENABLED:
            return _test_lifting(cfg, model, max_batches)
        if saved is not None:
            recompute_bn(cfg, model, max_batches)
        return _evaluate(cfg, model, max_batches, double_buffer)
    finally:
        if saved is not None:
            with torch.no_grad():
                for b, s in zip(model.buffers(), saved):
                    b.copy_(s)
        model.train(was_training)


def _evaluate(cfg: Config, model: torch.nn.Module, max_batches: Optional[int],
              double_buffer: bool) -> Dict[str, float]:
    device = _device_of(model)
    eval_step = make_eval_step(cfg, model, device, train_bn=cfg.TEST.TRAIN_BN)
    record = EvalRecord()

    def process(ib, group, host, event, tag):
        if event is not None:
            event.synchronize()  # this group's copies only
        out = {k: v.numpy() for k, v in host.items()}
        if cfg.VIS.VIDEO:
            dump_eval_frames(cfg, group, out["batch_locs"].astype(np.float64), tag, ib)
        process_group(cfg, group, out, record, ib, device)

    for ids, loader in enumerate(make_eval_loaders(cfg)):
        tag = f"ds{ids}"
        pending = None
        for ib, batch in enumerate(loader):
            if max_batches is not None and ib >= max_batches:
                break
            group = {k: v[0] for k, v in batch.items()}
            if cfg.VIS.VIDEO_GT:
                # the ground-truth overlay: frames only, no forward
                dump_gt_frames(cfg, group, tag, ib)
                continue
            current = (ib, group, *fetch_outputs(eval_step(group), host_output_keys(cfg, group)),
                       tag)
            if not double_buffer:
                process(*current)
                continue
            if pending is not None:
                process(*pending)
            pending = current
        if pending is not None:
            process(*pending)

    if cfg.VIS.SAVE_PRED and record.predictions and cfg.OUTPUT_DIR:
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        path = pred_pickle_path(cfg, cfg.OUTPUT_DIR)
        with open(path, "wb") as f:
            pickle.dump(record.predictions, f)
        if record.err_joints:
            with open(os.path.join(cfg.OUTPUT_DIR, "pck.pkl"), "wb") as f:
                pickle.dump({"err_joints": np.concatenate(record.err_joints),
                             "total_joints": np.concatenate(record.total_joints)}, f)
        logger.info("saved %d predictions to %s", len(record.predictions), path)

    results = record.meters.get_all_avg()
    logger.info("eval: %s", results)
    return results
