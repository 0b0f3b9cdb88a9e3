"""2D evaluation metrics: PCK family and JDR (host-side numpy).

The port's own copy of epipolar_transformers_tpu/metrics/metrics2d.py
(reference modeling/metrics/metrics2d.py:118-324), over the port's
`get_max_preds`.  They run per eval group on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..ops.soft_argmax import get_max_preds


def calc_pck(predictions, groundtruth, visibility, thresholds):
    """PCK@t over visible joints (reference metrics2d.py:238-265).

    Args:
        predictions/groundtruth: (N, 2, J).
        visibility: (N, J).
    Returns:
        {'PCK@t': percent} dict.
    """
    predictions = np.asarray(predictions)
    groundtruth = np.asarray(groundtruth)
    visibility = np.asarray(visibility)
    N = len(predictions)
    J = predictions[0].shape[1]
    errs = []
    for i in range(N):
        for j in range(J):
            if visibility[i, j]:
                # reference uses [:1, j] — the x coordinate distance only
                errs.append(np.linalg.norm(predictions[i][:1, j] - groundtruth[i][:1, j]))
    errs = np.asarray(errs)
    return {f"PCK@{th}": float((errs < th).sum() * 100.0 / max(len(errs), 1)) for th in thresholds}


def calculate_err(predictions, groundtruth, visibility, thresholds, max_threshold):
    """PCK + per-image error-vs-threshold curve accumulators
    (reference metrics2d.py:199-235)."""
    predictions = np.asarray(predictions)
    groundtruth = np.asarray(groundtruth)
    visibility = np.asarray(visibility)
    N = len(predictions)
    J = predictions[0].shape[1]
    err_joints = np.zeros((N, int(max_threshold)))
    total_joints = np.zeros((N, 1))
    threshold = np.linspace(0, max_threshold, num=int(max_threshold))
    batch_errs = []
    for i in range(N):
        errs = []
        for j in range(J):
            if visibility[i, j]:
                d = np.linalg.norm(predictions[i][:1, j] - groundtruth[i][:1, j])
                errs.append(d)
                batch_errs.append(d)
        errs = np.asarray(errs)
        for t in range(threshold.size):
            err_joints[i][t] = float((errs < threshold[t]).sum())
        total_joints[i] = len(errs)
    PCKs = {
        f"PCK@{th}": float(sum(d < th for d in batch_errs) * 100.0 / max(len(batch_errs), 1))
        for th in thresholds
    }
    return PCKs, err_joints, total_joints


def _calc_dists(preds, target, normalize):
    """reference metrics2d.py:269-281."""
    preds = preds.astype(np.float32)
    target = target.astype(np.float32)
    dists = np.zeros((preds.shape[1], preds.shape[0]))
    for n in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            if target[n, c, 0] > 1 and target[n, c, 1] > 1:
                dists[c, n] = np.linalg.norm((preds[n, c] - target[n, c]) / normalize[n])
            else:
                dists[c, n] = -1
    return dists


def _dist_acc(dists, thr=0.5):
    valid = dists != -1
    n = valid.sum()
    if n > 0:
        return float((dists[valid] < thr).sum()) / n
    return -1


def jdr(output, target, thr=0.5):
    """Joint Detection Rate on heatmap argmaxes (reference metrics2d.py:294-324).

    Args:
        output/target: (N, J, H, W) numpy heatmaps.
    Returns:
        (per-joint acc array with overall at [0], avg_acc, cnt, preds)
    """
    pred, _ = get_max_preds(output)
    tgt, _ = get_max_preds(target)
    h, w = output.shape[2], output.shape[3]
    norm = np.ones((pred.shape[0], 2)) * np.array([h, w]) / 10
    dists = _calc_dists(pred, tgt, norm)

    J = output.shape[1]
    acc = np.zeros(J + 1)
    avg_acc = 0.0
    cnt = 0
    for i in range(J):
        acc[i + 1] = _dist_acc(dists[i], thr)
        if acc[i + 1] >= 0:
            avg_acc += acc[i + 1]
            cnt += 1
    avg_acc = avg_acc / cnt if cnt else 0.0
    if cnt != 0:
        acc[0] = avg_acc
    return acc, avg_acc, cnt, pred
