"""The port's 2D metrics and meters == the JAX package's.

`metrics/metrics2d.py` and `utils/metric_logger.py` are the port's own
numpy copies, so on the same seeded inputs every result is equal to the
JAX package's (no tolerance); JDR is also held to `metrics2d_golden.npz`,
captured from the reference implementation, at the JAX test's 1e-8.
"""

import os

import numpy as np
import pytest

from epipolar_transformers_tpu.metrics import metrics2d as jm
from epipolar_transformers_tpu.utils.metric_logger import MetricLogger as JMetricLogger
from epipolar_transformers_tpu_torch.metrics import metrics2d as m
from epipolar_transformers_tpu_torch.utils.metric_logger import MetricLogger

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "metrics2d_golden.npz")
THRESHOLDS = (1, 2, 5, 10, 20)


def _points(seed):
    """(N, 2, J) predictions and ground truth in image pixels, visibility
    with some joints hidden."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0, 64, (4, 2, 17))
    pred = gt + rng.randn(4, 2, 17) * rng.choice([0.5, 4.0, 30.0], (4, 1, 17))
    vis = (rng.rand(4, 17) > 0.2).astype(np.float32)
    return pred, gt, vis


def _heatmaps(seed):
    """(N, J, H, W) maps whose argmax lands anywhere, an all-negative map
    (masked prediction) and targets on the first rows/columns (the -1
    distances of `_calc_dists`)."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(3, 5, 16, 16).astype(np.float32)
    pred[0, 1] -= 2.0
    tgt = rng.rand(3, 5, 16, 16).astype(np.float32)
    tgt[1, 2] = 0.0
    tgt[1, 2, 0, 7] = 1.0
    tgt[2, 3] = 0.0
    tgt[2, 3, 9, 1] = 1.0
    return pred, tgt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pck_and_error_curves_equal_jax(seed):
    pred, gt, vis = _points(seed)
    assert m.calc_pck(pred, gt, vis, THRESHOLDS) == jm.calc_pck(pred, gt, vis, THRESHOLDS)
    got = m.calculate_err(pred, gt, vis, THRESHOLDS, 20.0)
    want = jm.calculate_err(pred, gt, vis, THRESHOLDS, 20.0)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_jdr_and_dists_equal_jax(seed):
    pred, tgt = _heatmaps(seed)
    acc, avg, cnt, preds = m.jdr(pred, tgt)
    jacc, javg, jcnt, jpreds = jm.jdr(pred, tgt)
    np.testing.assert_array_equal(acc, jacc)
    assert (avg, cnt) == (javg, jcnt)
    np.testing.assert_array_equal(preds, jpreds)
    norm = np.full((3, 2), 1.6)
    p, t = preds, m.get_max_preds(tgt)[0]
    dists = m._calc_dists(p, t, norm)
    np.testing.assert_array_equal(dists, jm._calc_dists(p, t, norm))
    assert (dists == -1).any()
    for thr in (0.5, 2.0):
        assert m._dist_acc(dists[2], thr) == jm._dist_acc(dists[2], thr)


def test_jdr_matches_reference_golden():
    g = np.load(FIXTURE)
    acc, avg, _, _ = m.jdr(g["pred"], g["gt"])
    np.testing.assert_allclose(avg, float(g["jdr_avg"]), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(acc, np.float64), g["jdr_detected"],
                               rtol=1e-8, atol=1e-8)


def test_metric_logger_equals_jax():
    rng = np.random.RandomState(0)
    got, want = MetricLogger(), JMetricLogger()
    for _ in range(30):  # past the 20-value window
        values = {"EPEmean_global": rng.rand() * 150, "JDR": np.float32(rng.rand())}
        got.update(**values)
        want.update(**values)
    assert got.get_all_avg() == want.get_all_avg()
    assert str(got) == str(want)
    assert got.JDR.avg == want.JDR.avg and got.JDR.median == want.JDR.median
