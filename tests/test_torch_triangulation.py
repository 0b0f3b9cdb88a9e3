"""The port's host triangulation, grid sampling and RPSM == the JAX package's.

* `geometry/host.py` is the port's own f64 numpy copy: on the same seeded
  points, confidences and rig (`tests/conftest.py:make_camera_ring`) the
  four triangulations, RANSAC hypotheses included, agree to rtol 1e-12;
  with an untrained R-152's heatmap peaks, pymvg is NaN in both where no
  view of a joint peaks above -1.
* `ops/grid_sample.py` is `F.grid_sample` behind the JAX signature
  (channels-last image, (..., 2) grid): held to the JAX version at rtol
  1e-6, atol 1e-6, and to `grid_sample_golden.npz` (the reference's torch)
  at the JAX test's 1e-5.
* RPSM's unary term samples on the heatmaps' device with one batched
  `F.grid_sample`: rtol 1e-5, atol 1e-6 against the JAX one; a small `rpsm`
  (first_nbins 4, recur_nbins 2, recur_depth 2) gives the JAX bins, so the
  same points bit for bit (no tie shows up on these inputs).
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.conftest import make_camera_ring
from epipolar_transformers_tpu.geometry import host as jhost
from epipolar_transformers_tpu.geometry import pictorial as jpict
from epipolar_transformers_tpu.geometry.body import HumanBody as JHumanBody
from epipolar_transformers_tpu.ops.grid_sample import grid_sample_2d as jgrid_sample_2d
from epipolar_transformers_tpu_torch.config import Config, update_from_dict
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.geometry import host, pictorial
from epipolar_transformers_tpu_torch.geometry.body import HumanBody, compute_limb_length
from epipolar_transformers_tpu_torch.ops.grid_sample import grid_sample_2d

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "grid_sample_golden.npz")
EXACT = dict(rtol=1e-12, atol=1e-12)


def _observations(seed, n_joints=9):
    """Noisy projections of random joints into the 4-camera ring, one view
    an outlier, and confidences that leave some joints with 0, 1 or 2
    confident views."""
    ring = make_camera_ring()
    rng = np.random.RandomState(seed)
    X = rng.randn(n_joints, 3) * 200 + [0, 0, 1000]
    Xh = np.concatenate([X, np.ones((n_joints, 1))], axis=1)
    x = np.einsum("vij,nj->vni", ring["KRT"], Xh)
    pts = x[..., :2] / x[..., 2:] + rng.randn(4, n_joints, 2) * 1.5
    pts[1, ::3] += 60.0
    confs = rng.rand(4, n_joints)
    confs[:, 0] = [0.9, 0.01, 0.02, 0.03]  # one confident view
    confs[:, 1] = 0.01                      # none
    return ring, X, pts, confs


@pytest.mark.parametrize("seed", [0, 1])
def test_host_triangulations_equal_jax(seed):
    ring, X, pts, confs = _observations(seed)
    for refine in (False, True):
        np.testing.assert_allclose(
            host.triangulate_ransac_np(pts, ring["KRT"], confs, 0.05, 3.0, refine=refine),
            jhost.triangulate_ransac_np(pts, ring["KRT"], confs, 0.05, 3.0, refine=refine),
            **EXACT)
    got = host.triangulate_pymvg_np(pts, ring["K"], ring["RT"], confs, conf_thres=0.5)
    np.testing.assert_allclose(
        got, jhost.triangulate_pymvg_np(pts, ring["K"], ring["RT"], confs, conf_thres=0.5),
        **EXACT)
    assert np.linalg.norm(got - X, axis=-1).min() < 10.0
    # corr_pos in feature pixels at stride 4 on a 64x64 map
    corr = np.random.RandomState(seed + 10).uniform(0, 63, (4, 64, 64, 2))
    other = ring["KRT"][[1, 0, 3, 2]]
    for dlt in (False, True):
        args = (pts, ring["KRT"], ring["K"], ring["RT"], confs, corr, other, 0.5, 3.0)
        np.testing.assert_allclose(host.triangulate_epipolar_np(*args, dlt=dlt),
                                   jhost.triangulate_epipolar_np(*args, dlt=dlt), **EXACT)
    np.testing.assert_allclose(host.dlt_triangulate_np(pts[:, 2], ring["KRT"]),
                               jhost.dlt_triangulate_np(pts[:, 2], ring["KRT"]), **EXACT)


@pytest.mark.parametrize("seed", [0, 1])
def test_pymvg_is_nan_in_both_packages_where_no_view_peaks_above_minus_one(seed):
    """Heatmap peaks as an untrained R-152 gives them (-4e3 .. 2.4e4,
    scripts/torch_r152_eval_nan.py): a joint whose every view peaks below
    -1 leaves the adaptive threshold no view, and both packages return
    NaN for it; the other joints agree."""
    ring, X, pts, _ = _observations(seed)
    rng = np.random.RandomState(seed + 20)
    confs = rng.uniform(-4e3, 2.4e4, (4, len(X)))
    confs[:, 2] = -rng.uniform(2, 4e3, 4)
    confs[:, 5] = [-3.0, -40.0, -2.0, -500.0]
    got = host.triangulate_pymvg_np(pts, ring["K"], ring["RT"], confs, conf_thres=0.05)
    want = jhost.triangulate_pymvg_np(pts, ring["K"], ring["RT"], confs, conf_thres=0.05)
    nan = np.isnan(got).any(axis=-1)
    assert nan[[2, 5]].all()
    np.testing.assert_array_equal(nan, np.isnan(want).any(axis=-1))
    np.testing.assert_allclose(got[~nan], want[~nan], **EXACT)


def test_grid_sample_2d_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(9, 13, 5).astype(np.float32)
    # interior, edges and far out-of-range samples
    grid = rng.uniform(-1.5, 1.5, (6, 7, 2)).astype(np.float32)
    got = grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid))
    assert got.shape == (6, 7, 5)
    want = np.asarray(jgrid_sample_2d(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    outside = grid_sample_2d(torch.from_numpy(img), torch.tensor([[-5.0, -5.0], [5.0, 0.0]]))
    assert outside.abs().max().item() == 0.0


def test_grid_sample_2d_matches_reference_golden():
    g = np.load(FIXTURE)
    x, grid = g["x"], g["grid"]  # (2, 3, 9, 11) NCHW, (2, 5, 7, 2)
    for ac in (True, False):
        want = g[f"out_ac{int(ac)}"]  # (2, 3, 5, 7)
        for n in range(x.shape[0]):
            out = grid_sample_2d(torch.from_numpy(x[n].transpose(1, 2, 0).copy()),
                                 torch.from_numpy(grid[n]), align_corners=ac)
            np.testing.assert_allclose(out.numpy(), want[n].transpose(1, 2, 0),
                                       rtol=1e-5, atol=1e-5, err_msg=f"align_corners={ac}")


@pytest.fixture(scope="module")
def rig_item():
    """One 17-joint view group of the synthetic rig at 64 px (16x16
    heatmaps), its boxes (image centre and scale) and cameras, as
    tests/test_pictorial.py sets them."""
    cfg = update_from_dict(Config(), {
        "DATASETS": {"IMAGE_SIZE": (64, 64), "IMAGE_RESIZE": 1.0, "PREDICT_RESIZE": 1.0},
        "BACKBONE": {"DOWNSAMPLE": 4},
        "KEYPOINT": {"NUM_PTS": 17, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
    })
    item = SyntheticMultiview(cfg, is_train=False, n_samples=1)[0]
    boxes = [{"center": np.array([32.0, 32.0]), "scale": np.array([0.32, 0.32])}] * 4
    return item, item["heatmap"].transpose(0, 3, 1, 2), boxes, item["K"] @ item["RT"]


def test_unary_term_matches_jax(rig_item):
    item, heatmaps, boxes, cams = rig_item
    gt = item["points-3d"].astype(np.float64)
    shared = [pictorial.compute_grid(2000.0, gt[0], 8)]
    per_joint = [pictorial.compute_grid(250.0, p, 2) for p in gt]
    for grids in (shared, per_joint):
        for correct_offset in (True, False):
            got = pictorial.compute_unary_term(torch.from_numpy(heatmaps), grids, boxes, cams,
                                               (64, 64), correct_offset)
            want = jpict.compute_unary_term(heatmaps, grids, boxes, cams, (64, 64),
                                            correct_offset)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert np.ptp(got) > 1e-3  # the bins see the joints, not only the floor


def test_pairwise_and_tree_equal_jax(rig_item):
    item, heatmaps, boxes, cams = rig_item
    gt = item["points-3d"].astype(np.float64)
    body, jbody = HumanBody(), JHumanBody()
    limb = compute_limb_length(body, gt)
    grid = pictorial.compute_grid(2000.0, gt[0], 6)
    pw = pictorial.compute_pairwise(body.skeleton, limb, [grid] * 17, 150.0)
    jpw = jpict.compute_pairwise(jbody.skeleton, limb, [grid] * 17, 150.0)
    assert pw.keys() == jpw.keys()
    for k in pw:
        np.testing.assert_array_equal(pw[k], jpw[k])
    unary = np.random.RandomState(0).rand(17, 216).astype(np.float32)
    assert pictorial.infer(unary, pw, body) == jpict.infer(unary, jpw, jbody)


def test_rpsm_gives_the_jax_bins(rig_item):
    item, heatmaps, boxes, cams = rig_item
    gt = item["points-3d"].astype(np.float64)
    kw = dict(center=gt[0], boxes=boxes, limb_length=compute_limb_length(HumanBody(), gt),
              img_size=(64, 64), grid_size=2000.0, first_nbins=4, recur_nbins=2,
              recur_depth=2, tolerance=150.0)
    got = pictorial.rpsm(cams, torch.from_numpy(heatmaps), body=HumanBody(), **kw)
    want = jpict.rpsm(cams, heatmaps, body=JHumanBody(), **kw)
    np.testing.assert_array_equal(got, want)
