"""The batched triangulation, the affine builders, the camera model and the
depth oracle of the port against the JAX package.

`geometry/triangulate.py` (torch) against JAX `geometry/triangulate.py` on
the conftest camera ring, in float64 on both sides (x64 is on in the
tests), at the tolerances tests/test_triangulate.py uses for the JAX
functions against numpy and the ground truth: DLT rtol 1e-6 (the null
vector of the same rows; here against JAX's own result), masked views
rtol 1e-5 / atol 1e-4, point-line distances atol 1e-4 px, pymvg rtol 1e-4
/ atol 1e-2 mm.  RANSAC is fed JAX's own draws (`jax.random.categorical`
with JAX's keys, as JAX `_ransac_one_joint` draws them), so the port must
pick the same hypotheses: the same points within rtol 1e-6 / atol 1e-6 mm,
zeros included.  Its own draws come from a `torch.Generator` (ROADMAP C20)
and are held to the ground truth as the JAX tests hold JAX's.

`geometry/affine_utils.py` against the JAX builders (atol 1e-6, f32);
`geometry/camera_model.py` is a copy, held equal bit for bit; the oracle
warp against JAX `depth_oracle_warp` (f64, rtol 1e-9 / atol 1e-9: the same
arithmetic and the same bilinear taps).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.geometry import affine_utils as jaffine
from epipolar_transformers_tpu.geometry import camera_model as jcm
from epipolar_transformers_tpu.geometry import triangulate as jtri
from epipolar_transformers_tpu.models.oracle import depth_oracle_warp as jax_oracle
from epipolar_transformers_tpu_torch.geometry import affine_utils, camera_model
from epipolar_transformers_tpu_torch.geometry import triangulate as tri
from epipolar_transformers_tpu_torch.models.oracle import depth_oracle_warp
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

DLT_RTOL = 1e-6
RANSAC_TOL = dict(rtol=1e-6, atol=1e-6)
PYMVG_TOL = dict(rtol=1e-4, atol=1e-2)


def _project(KRTs, X):
    Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
    x = np.einsum("vij,nj->vni", KRTs, Xh)
    return x[..., :2] / x[..., 2:]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def test_dlt_matches_jax(camera_ring):
    rng = np.random.RandomState(0)
    X = rng.randn(17, 3) * 300 + [0, 0, 1000]
    pts = _project(camera_ring["KRT"], X) + rng.randn(4, 17, 2)
    KRT = camera_ring["KRT"]
    want = np.asarray(jax.vmap(lambda p: jtri.dlt_triangulate(p, jnp.asarray(KRT)),
                               in_axes=1)(jnp.asarray(pts)))
    got = tri.dlt_triangulate(_t(pts).transpose(0, 1), _t(KRT).expand(17, 4, 3, 4)).numpy()
    np.testing.assert_allclose(got, want, rtol=DLT_RTOL)
    w = np.array([1.0, 1.0, 1.0, 0.0])
    want_w = np.asarray(jtri.dlt_triangulate(jnp.asarray(pts[:, 0]), jnp.asarray(KRT),
                                             jnp.asarray(w)))
    got_w = tri.dlt_triangulate(_t(pts[:, 0]), _t(KRT), _t(w)).numpy()
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-4)
    pair_want = np.asarray(jtri.dlt_triangulate_pair(*map(jnp.asarray, (KRT[0], KRT[2],
                                                                         pts[0, 3], pts[2, 3]))))
    pair_got = tri.dlt_triangulate_pair(_t(KRT[0]), _t(KRT[2]), _t(pts[0, 3]),
                                        _t(pts[2, 3])).numpy()
    np.testing.assert_allclose(pair_got, pair_want, rtol=DLT_RTOL)


def test_point_line_distances_match_jax(camera_ring):
    rng = np.random.RandomState(1)
    X = rng.randn(6, 3) * 200 + [0, 0, 1000]
    pts = _project(camera_ring["KRT"], X)[:, 0] + rng.randn(4, 2) * 3
    for p3d in X:
        want = np.asarray(jtri.point_line_distances(jnp.asarray(p3d), jnp.asarray(pts),
                                                    jnp.asarray(camera_ring["KRT"])))
        got = tri.point_line_distances(_t(p3d), _t(pts), _t(camera_ring["KRT"])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-4)


def _jax_pairs(confs, key, conf_thres=0.05, n_iter=tri.RANSAC_ITER):
    """JAX `_ransac_one_joint`'s draws for every joint, as (J, n_iter)."""
    keys = jax.random.split(key, confs.shape[1])
    a, b = [], []
    for j in range(confs.shape[1]):
        selected = (jnp.asarray(confs[:, j]) > conf_thres).astype(jnp.float64)
        probs = selected / jnp.maximum(jnp.sum(selected), 1)
        ka, kb = jax.random.split(keys[j])
        a.append(np.asarray(jax.random.categorical(ka, jnp.log(probs + 1e-30), shape=(n_iter,))))
        b.append(np.asarray(jax.random.categorical(kb, jnp.log(probs + 1e-30), shape=(n_iter,))))
    return torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(b))


@pytest.mark.parametrize("refine", [False, True], ids=["ransac", "refine"])
def test_ransac_on_jax_draws_matches_jax(camera_ring, refine):
    rng = np.random.RandomState(2)
    X = rng.randn(9, 3) * 200 + [0, 0, 1000]
    pts = _project(camera_ring["KRT"], X) + rng.randn(4, 9, 2) * 0.7
    pts[1, ::2] += 80.0  # an outlier view on every other joint
    confs = rng.rand(4, 9)
    confs[:, 0] = [0.9, 0.01, 0.01, 0.01]  # one confident view: zeros
    confs[:, 1] = [0.9, 0.9, 0.01, 0.01]  # two
    key = jax.random.PRNGKey(3)
    fn = jtri.triangulate_refine if refine else jtri.triangulate_ransac
    want = np.asarray(fn(jnp.asarray(pts), jnp.asarray(camera_ring["KRT"]), jnp.asarray(confs),
                         key, ransac_thres=5.0))
    port = tri.triangulate_refine if refine else tri.triangulate_ransac
    got = port(_t(pts), _t(camera_ring["KRT"]), _t(confs), ransac_thres=5.0,
               pairs=_jax_pairs(confs, key)).numpy()
    np.testing.assert_allclose(got, want, **RANSAC_TOL)
    np.testing.assert_array_equal(got[0], 0.0)


def test_ransac_from_a_torch_generator(camera_ring):
    """C20: the port's own draws.  The JAX tests' outlier case and its
    too-few-views case, and two runs from one seed bit-equal."""
    rng = np.random.RandomState(2)
    X = rng.randn(5, 3) * 200 + [0, 0, 1000]
    pts = _project(camera_ring["KRT"], X)
    pts[1] += 80.0
    confs = np.ones((4, 5))
    runs = [tri.triangulate_ransac(_t(pts), _t(camera_ring["KRT"]), _t(confs),
                                   torch.Generator().manual_seed(0)).numpy() for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert np.linalg.norm(runs[0] - X, axis=-1).max() < 5.0
    confs = np.array([[0.9], [0.01], [0.01], [0.01]])
    one = tri.triangulate_refine(_t(pts[:, :1]), _t(camera_ring["KRT"]), _t(confs),
                                 torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(one, 0.0)
    a, b = tri.ransac_pairs(torch.tensor([[1.0, 0.0, 1.0, 1.0]]), 200,
                            torch.Generator().manual_seed(1))
    assert a.shape == (1, 200) and not (a == 1).any() and not (b == 1).any()


@pytest.mark.parametrize("case", ["all", "adaptive", "none"])
def test_pymvg_matches_jax(camera_ring, case):
    rng = np.random.RandomState(4)
    X = rng.randn(17, 3) * 250 + [0, 0, 1000]
    pts = _project(camera_ring["KRT"], X) + rng.randn(4, 17, 2) * 0.3
    confs = {"all": np.ones((4, 17)),
             "adaptive": np.tile([[0.9], [0.04], [0.01], [0.01]], (1, 17)),
             "none": np.full((4, 17), -2.0)}[case]
    want = np.asarray(jtri.triangulate_pymvg(jnp.asarray(pts), jnp.asarray(camera_ring["K"]),
                                             jnp.asarray(camera_ring["RT"]),
                                             jnp.asarray(confs), conf_thres=0.05))
    got = tri.triangulate_pymvg(_t(pts), _t(camera_ring["K"]), _t(camera_ring["RT"]),
                                _t(confs), conf_thres=0.05).numpy()
    np.testing.assert_allclose(got, want, **PYMVG_TOL)
    sel_want = np.asarray(jtri._adaptive_selection(jnp.asarray(confs[:, 0]), 0.05))
    sel_got = tri.adaptive_selection(_t(confs[:, 0]), 0.05).numpy()
    np.testing.assert_array_equal(sel_got, sel_want)


def test_affine_builders_match_jax():
    rng = np.random.RandomState(5)
    pts = rng.rand(7, 2).astype(np.float32) * 2 - 1
    thetas = [(affine_utils.identity_theta(), jaffine.identity_theta()),
              (affine_utils.crop2affine((-0.5, -0.25, 0.5, 0.75)),
               jaffine.crop2affine((-0.5, -0.25, 0.5, 0.75))),
              (affine_utils.scale2affine(0.5, 2.0), jaffine.scale2affine(0.5, 2.0)),
              (affine_utils.offset2affine(0.1, -0.3), jaffine.offset2affine(0.1, -0.3)),
              (affine_utils.mirror2affine(True), jaffine.mirror2affine(True)),
              (affine_utils.mirror2affine(False), jaffine.mirror2affine(False)),
              (affine_utils.rotate2affine(0.7), jaffine.rotate2affine(0.7))]
    for got, want in thetas:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(
            affine_utils.apply_theta(got, torch.from_numpy(pts)).numpy(),
            np.asarray(jaffine.apply_theta(jnp.asarray(want, jnp.float32), jnp.asarray(pts))),
            atol=1e-6)
    a, b = thetas[6][0], thetas[1][0]
    np.testing.assert_allclose(affine_utils.compose(a, b).numpy(),
                               np.asarray(jaffine.compose(thetas[6][1], thetas[1][1])),
                               atol=1e-6)
    theta = np.array([[0.8, -0.2, 0.1], [0.3, 1.1, -0.4]], np.float32)
    dst = pts @ theta[:, :2].T + theta[:, 2]
    np.testing.assert_allclose(
        affine_utils.solve_theta(torch.from_numpy(pts), torch.from_numpy(dst)).numpy(),
        np.asarray(jaffine.solve_theta(jnp.asarray(pts), jnp.asarray(dst))), atol=1e-5)
    px = np.array([[3.0, 5.0], [63.0, 0.0]], np.float32)
    for correct in (True, False):
        n = affine_utils.normalize_points(torch.from_numpy(px), 64, 48, correct)
        np.testing.assert_allclose(
            n.numpy(), np.asarray(jaffine.normalize_points(jnp.asarray(px), 64, 48, correct)),
            atol=1e-6)
        np.testing.assert_allclose(affine_utils.denormalize_points(n, 64, 48, correct).numpy(),
                                   px, atol=1e-4)


def test_camera_model_copy_matches_jax(camera_ring):
    rng = np.random.RandomState(6)
    M = camera_ring["KRT"][1]
    got, want = camera_model.CameraModel.from_M(M), jcm.CameraModel.from_M(M)
    for k in ("K", "R", "t", "D"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    D = [0.1, -0.05, 0.001, 0.002, 0.01]
    cams, jcams = [], []
    for v in range(4):
        K, R = camera_ring["K"][v], camera_ring["RT"][v][:, :3]
        t = camera_ring["RT"][v][:, 3]
        cams.append(camera_model.CameraModel(K, R, t, D, name=f"c{v}"))
        jcams.append(jcm.CameraModel(K, R, t, D, name=f"c{v}"))
    X = rng.randn(5, 3) * 200 + [0, 0, 1000]
    for c, j in zip(cams, jcams):
        px = c.project_3d_to_pixel(X)
        np.testing.assert_array_equal(px, j.project_3d_to_pixel(X))
        np.testing.assert_array_equal(c.undistort(px), j.undistort(px))
        np.testing.assert_array_equal(c.distort(px), j.distort(px))
        for g, w in zip(c.project_pixel_to_3d_ray(px), j.project_pixel_to_3d_ray(px)):
            np.testing.assert_array_equal(g, w)
    sys_, jsys = camera_model.MultiCameraSystem(cams), jcm.MultiCameraSystem(jcams)
    obs = [(f"c{v}", cams[v].project_3d_to_pixel(X[0])[0]) for v in range(4)]
    np.testing.assert_array_equal(sys_.find3d(obs), jsys.find3d(obs))
    np.testing.assert_array_equal(sys_.find2d("c2", X), jsys.find2d("c2", X))
    np.testing.assert_array_equal(camera_model.rq_decomposition(M[:, :3])[0],
                                  jcm.rq_decomposition(M[:, :3])[0])


def test_depth_oracle_warp_matches_jax(camera_ring):
    rng = np.random.RandomState(7)
    N, H, W, C = 2, 8, 8, 3
    feat = rng.randn(N, 2, H, W, C)
    d1, d2 = rng.rand(N, H, W) * 500 + 3800, rng.rand(N, H, W) * 500 + 3800
    # the ring's cameras at the 8x8 maps' scale, so that warped pixels land
    # inside the other view
    K = np.stack([np.diag([W / 256.0, H / 256.0, 1.0]) @ camera_ring["K"][v] for v in (0, 1)])
    R = np.stack([camera_ring["RT"][0][:, :3], camera_ring["RT"][1][:, :3]])
    t = np.stack([camera_ring["RT"][0][:, 3], camera_ring["RT"][1][:, 3]])
    bbox = np.tile([[0.0, 0.0, float(W), float(H)]], (N, 1))
    args = (feat, d1, d2, K, R, t, K[::-1].copy(), R[::-1].copy(), t[::-1].copy(), bbox, bbox)
    want = np.asarray(jax_oracle(*map(jnp.asarray, args), full_w=1, full_h=1))
    got = depth_oracle_warp(*map(_t, args), full_w=1, full_h=1).numpy()
    assert got.shape == want.shape == (N, 2, H, W, 2 * C)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert (np.abs(want[..., C:]).max(-1) > 0).mean() > 0.25  # warped pixels land inside
