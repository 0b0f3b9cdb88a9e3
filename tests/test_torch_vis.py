"""The port's visualization (vis/) against the JAX package's, with no cv2 or
PIL on the port's side.

  * `render_pose_frame` against JAX's (cv2 LINE_AA) on the same images and
    joints, in the three skeletons (human36m, mpii, hand), joints inside
    and outside the image: pixels more than one pixel from anything either
    drew are bit-equal, and each side's drawn pixels lie within a 1-px
    dilation (3x3) of the other's (ROADMAP C21); the primitives alone on
    random segments and discs the same way;
  * `rgb_to_lab_u8` within one level of cv2's COLOR_RGB2Lab on every third
    level of each channel and 200000 random colours (C22);
  * the AVI: `read_avi` gives back the PNG frames bit for bit, and so does
    ffmpeg through cv2.VideoCapture, an independent reader (C23: AVI, not
    mp4v);
  * the copies (skeleton tables, cursor, ipv frusta) equal, the score
    curves against JAX's (the ab scores within 1e-6 on colours where the
    two Labs agree, the argmax equal);
  * `epipolar_introspection` against JAX's on the same weights (the JAX
    init carried across; the layer's own come from a torch generator, C24),
    its convolutions at the heatmaps' width as flax infers them
    and the JAX sample locations: attention and fused rtol 1e-4 / atol
    1e-5, corr_pos 2e-3 px (tests/test_torch_slice.py's);
  * `dump_epipolar_debug_pair`, the hand panels, and the two offline
    scripts: scripts/torch_post_visualization.py's summary equal to
    scripts/post_visualization.py's; scripts/torch_undistort_h36m.py's
    frames, decoded, within 1 level on average and 16 at worst of the JAX
    script's (C25: the port undistorts as cv2.undistort and encodes with
    its own JPEG encoder, JAX remaps with float maps and encodes with cv2;
    measured 0.35 and 7 on 120 px frames).
"""

import os
import pickle
import subprocess
import sys
import zipfile

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy import ndimage

from epipolar_transformers_tpu.models.epipolar import Epipolar as JEpipolar
from epipolar_transformers_tpu.vis import cursor as jcursor
from epipolar_transformers_tpu.vis import ipv_vis as jipv
from epipolar_transformers_tpu.vis import score_curves as jscore
from epipolar_transformers_tpu.vis import skeletons as jskeletons
from epipolar_transformers_tpu.vis import visualization as jvis
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.image_io import read_png
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader
from epipolar_transformers_tpu_torch.models import epipolar as port_epipolar
from epipolar_transformers_tpu_torch.vis import cursor, ipv_vis, score_curves, skeletons
from epipolar_transformers_tpu_torch.vis import visualization as vis
from torch_configs import config_pair, jax_sample_locs, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DILATE = np.ones((3, 3), bool)
INTROSPECTION_TOL = dict(rtol=1e-4, atol=1e-5)
UNDISTORT_MEAN, UNDISTORT_MAX = 1.0, 16


def _cfgs(d=None):
    base = {"DATASETS": {"TASK": "multiview_keypoint", "IMAGE_SIZE": (64, 64)},
            "BACKBONE": {"DOWNSAMPLE": 4},
            "KEYPOINT": {"NUM_PTS": 17, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
            "EPIPOLAR": {"SAMPLESIZE": 8, "ATTENTION": "avg", "SIMILARITY": "dot",
                         "USE_CORRECT_NORMALIZE": True}}
    for k, v in (d or {}).items():
        base[k] = {**base.get(k, {}), **v}
    return config_pair(base)


@pytest.fixture(scope="module")
def group():
    cfg, _ = _cfgs()
    return {k: v[0] for k, v in next(iter(EvalLoader(SyntheticMultiview(cfg, False,
                                                                           n_samples=1)))).items()}


def _drawn(frame, base):
    return (frame != base).any(-1)


@pytest.mark.parametrize("kind,joints", [("human36m", 17), ("mpii", 16), ("hand", 21)])
def test_render_pose_frame_against_jax(group, kind, joints):
    rng = np.random.RandomState(joints)
    for v in range(group["img"].shape[0]):
        img = group["img"][v]
        pts = rng.rand(joints, 2) * 80 - 8  # some joints outside the 64 px image
        if kind == "human36m":
            pts[:17] = group["points-2d"][v] + rng.randn(17, 2)
        vis_ = (rng.rand(joints) > 0.15).astype(np.float32)
        base = vis.render_pose_frame(img, np.zeros((0, 2)), kind=kind)
        got = vis.render_pose_frame(img, pts, kind=kind, visibility=vis_)
        want = jvis.render_pose_frame(img, pts, kind=kind, visibility=vis_)
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        dg, dw = _drawn(got, base), _drawn(want, base)
        assert dg.any() and dw.any()
        assert (dg <= ndimage.binary_dilation(dw, DILATE)).all()
        assert (dw <= ndimage.binary_dilation(dg, DILATE)).all()
        far = ~ndimage.binary_dilation(dg | dw, DILATE)
        np.testing.assert_array_equal(got[far], want[far])


def test_raster_lines_and_discs_against_cv2():
    """The two primitives alone, on 1200 random segments (ends off the image
    too) and discs.  A segment with less than one pixel of its length inside
    the image is drawn by cv2 as 0 to 2 pixels depending on the edge it
    touches; the port draws by distance.  Those are counted and left out of
    the line check (C21); everything else is held."""
    rng = np.random.RandomState(0)
    short = 0
    for i in range(1200):
        H, W = ((48, 64), (64, 64), (40, 30))[i % 3]
        base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        p0, p1 = (tuple(int(v) for v in rng.randint(-6, 70, 2)) for _ in range(2))
        c = tuple(int(v) for v in rng.randint(0, 64, 2))
        r = int(rng.randint(1, 4))
        seg = vis._clip_segment(p0, p1, W, H)
        if seg is None or np.hypot(*np.subtract(seg[1], seg[0])) < 1:
            short += 1
            p0 = p1 = (-10, -10)  # off the image: nothing drawn by either
        want = base.copy()
        cv2.line(want, p0, p1, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.circle(want, c, r, (0, 0, 255), -1, cv2.LINE_AA)
        got = base.copy()
        vis.draw_line_aa(got, p0, p1, (0, 255, 0))
        vis.draw_disc_aa(got, c, r, (0, 0, 255))
        dg, dw = _drawn(got, base), _drawn(want, base)
        assert (dg <= ndimage.binary_dilation(dw, DILATE)).all(), (p0, p1, c, r)
        assert (dw <= ndimage.binary_dilation(dg, DILATE)).all(), (p0, p1, c, r)
    assert short < 600  # most segments are held


def test_lab_within_one_level_of_cv2():
    g = np.arange(0, 256, 3, dtype=np.uint8)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 1, 3)
    rand = np.random.RandomState(1).randint(0, 256, (200000, 1, 3)).astype(np.uint8)
    img = np.concatenate([grid, rand])
    got = score_curves.rgb_to_lab_u8(img).astype(int)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2Lab).astype(int)
    assert np.abs(got - want).max() <= 1


def test_avi_reads_back_to_the_png_frames(tmp_path, group):
    cfg, jcfg = _cfgs({"VIS": {"VIDEO": True}})
    cfg = cfg.replace(OUTPUT_DIR=str(tmp_path))
    rng = np.random.RandomState(2)
    for idx in range(3):
        locs = group["points-2d"] + rng.randn(*group["points-2d"].shape)
        assert vis.dump_eval_frames(cfg, group, locs, "ds0", idx) == group["img"].shape[0]
    produced = vis.visualization(cfg, "cpu")
    assert produced == {"video/ds0": 3}
    avi = tmp_path / "video" / "ds0.avi"
    frames = vis.read_avi(str(avi))
    views = sorted(os.listdir(tmp_path / "video" / "ds0"))
    assert len(frames) == 3 and len(views) == 4
    for i, frame in enumerate(frames):
        h, w = 64, 64
        for v, view in enumerate(views):
            png = read_png(str(tmp_path / "video" / "ds0" / view / f"{i:08d}.png"))
            r, c = divmod(v, 2)
            np.testing.assert_array_equal(frame[r * h:(r + 1) * h, c * w:(c + 1) * w],
                                          png[..., ::-1])
            np.testing.assert_array_equal(
                png[..., ::-1], cv2.imread(str(tmp_path / "video" / "ds0" / view /
                                               f"{i:08d}.png")))
    cap = cv2.VideoCapture(str(avi), cv2.CAP_FFMPEG)
    decoded = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(f)
    cap.release()
    assert len(decoded) == 3
    for a, b in zip(decoded, frames):
        np.testing.assert_array_equal(a, b)


def test_copies_match_jax(camera_ring):
    assert skeletons.CONNECTIVITY_DICT == jskeletons.CONNECTIVITY_DICT
    assert skeletons.HAND_BONES == jskeletons.HAND_BONES
    np.testing.assert_array_equal(
        ipv_vis.camera_frustum_lines(camera_ring["K"][0], camera_ring["R"][0],
                                     camera_ring["T"][0]),
        jipv.camera_frustum_lines(camera_ring["K"][0], camera_ring["R"][0], camera_ring["T"][0]))
    out = ipv_vis.plot_scene(np.zeros((3, 3)), [(camera_ring["K"][1], camera_ring["R"][1],
                                                 camera_ring["T"][1])])
    assert out["figure"] is None and len(out["frusta"]) == 1

    class Event:
        def __init__(self, ax, x, y):
            self.inaxes, self.xdata, self.ydata, self.canvas = ax, x, y, None

    rng = np.random.RandomState(3)
    locs = rng.rand(6, 8, 8, 2) * 2 - 1
    att = rng.rand(6, 8, 8)
    ax_ref, ax_other = _Axis(), _Axis()
    got = cursor.EpipolarCursor(ax_ref, ax_other, locs, att, 4).on_move(Event(ax_ref, 13.0, 21.0))
    want = jcursor.EpipolarCursor(ax_ref, ax_other, locs, att, 4).on_move(
        Event(ax_ref, 13.0, 21.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Axis:
    """The two axis calls EpipolarCursor makes."""

    def scatter(self, *a, **k):
        return self

    def remove(self):
        pass


def test_score_curves_match_jax():
    rng = np.random.RandomState(4)
    H = W = 64
    img_ref = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    img_other = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    lab_same = (score_curves.rgb_to_lab_u8(img_other) == cv2.cvtColor(
        img_other, cv2.COLOR_RGB2Lab)).all()
    K, h, w = 16, 16, 16
    sample_locs = np.zeros((K, h, w, 2), np.float32)
    sample_locs[..., 0] = np.linspace(-1, 1, K)[:, None, None]
    sample_locs[..., 1] = np.linspace(-1, 1, h)[None, :, None]
    dump = {"sample_locs": sample_locs, "attention": rng.rand(1, K, h, w).astype(np.float32),
            "corr_pos": (rng.rand(1, h, w, 2) * 60).astype(np.float32)}
    got = score_curves.score_curves(dump, 30.0, 22.0, img_ref=img_ref, img_other=img_other)
    want = jscore.score_curves(dump, 30.0, 22.0, img_ref=img_ref, img_other=img_other)
    assert set(got) == set(want)
    for k in want:
        if k == "rgb_matching" and not lab_same:
            assert np.argmax(got[k]) == np.argmax(want[k])
            np.testing.assert_allclose(got[k], want[k], rtol=0.05)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def _introspection_batch(group):
    return {"feat": group["heatmap"][:1].astype(np.float32),
            "other_feat": group["heatmap"][1:2].astype(np.float32),
            "KRT": group["KRT"][:1].astype(np.float32),
            "other_KRT": group["KRT"][1:2].astype(np.float32)}


@pytest.mark.parametrize("params,residual", [((), False), (("z",), True), (("z",), False)],
                         ids=["plain", "z_residual", "z"])
def test_epipolar_introspection_matches_jax(group, monkeypatch, params, residual):
    """NFEATS 17 with the residual (its sum needs z to keep the width), 256
    without: z widens the 17 heatmap channels to 256 in both packages."""
    cfg, jcfg = _cfgs({"KEYPOINT": {"NFEATS": 17 if residual else 256},
                       "EPIPOLAR": {"PARAMETERIZED": params, "ZRESIDUAL": residual},
                       "VIS": {"EPIPOLAR_LINE": True}})
    batch = _introspection_batch(group)
    jlayer = JEpipolar(jcfg)
    variables = jlayer.init(jax.random.PRNGKey(0), *map(jnp.asarray, (
        batch["feat"], batch["other_feat"], batch["KRT"], batch["other_KRT"])), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    layer = vis.introspection_layer(cfg, 17, "cpu", torch.Generator().manual_seed(0))
    assert layer.route == "plain"  # 17 channels: not a kernel width, in both packages
    if params:
        rng = np.random.RandomState(5)
        norm = variables["params"]["bn"]["norm"]
        norm["scale"] = rng.randn(*norm["scale"].shape).astype(np.float32)
        with torch.no_grad():
            layer.z.weight.copy_(torch.tensor(
                np.transpose(variables["params"]["z"]["kernel"], (3, 2, 0, 1))))
            layer.z.bias.copy_(torch.tensor(variables["params"]["z"]["bias"]))
            layer.bn.weight.copy_(torch.tensor(norm["scale"]))
            layer.bn.bias.copy_(torch.tensor(norm["bias"]))
    monkeypatch.setattr(port_epipolar, "epipolar_sample_locs", jax_sample_locs)
    got = vis.epipolar_introspection(cfg, layer, batch)
    want = jvis.epipolar_introspection(jcfg, variables, batch)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
    np.testing.assert_array_equal(got["sample_locs"], np.asarray(want["sample_locs"]))
    for k in ("attention", "fused"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **INTROSPECTION_TOL)
    np.testing.assert_allclose(got["corr_pos"], np.asarray(want["corr_pos"]), rtol=0, atol=2e-3)


def test_debug_pair_and_hand_panels_match_jax(tmp_path, group):
    cfg, jcfg = _cfgs()
    ret = {"img": group["img"][0], "other_img": group["img"][1], "KRT": group["KRT"][0],
           "other_KRT": group["KRT"][1], "points-2d": group["points-2d"][0],
           "points-3d": group["points-3d"][0]}
    got = vis.dump_epipolar_debug_pair(cfg.replace(OUTPUT_DIR=str(tmp_path / "port")), ret, 3)
    want = jvis.dump_epipolar_debug_pair(jcfg.replace(OUTPUT_DIR=str(tmp_path / "jax")), ret, 3)
    assert os.path.basename(got) == os.path.basename(want) == "00000003.png"
    assert read_png(got).shape == cv2.imread(want).shape == (64, 128, 3)
    rng = np.random.RandomState(6)
    preds = [({"visibility": np.ones(21), "can-points-3d": rng.randn(21, 3),
               "normed-points-3d": rng.randn(21, 3)},
              {"can_pred": rng.randn(21, 3), "normed_pred": rng.randn(21, 3)})
             for _ in range(2)]
    path = tmp_path / "preds.pkl"
    path.write_bytes(pickle.dumps(preds))
    assert vis.hand_comparison_panels(str(path), str(tmp_path / "p"), 1) == \
        jvis.hand_comparison_panels(str(path), str(tmp_path / "j"), 1) == 1
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j") == ["hand_panel_00000.png"]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(ROOT, "scripts", script), *args],
                          check=True, env=env, cwd=ROOT, capture_output=True, text=True)


def test_post_visualization_script_matches_jax(tmp_path):
    rng = np.random.RandomState(7)
    t = np.linspace(-1, 1, 8)
    locs = np.broadcast_to(np.stack([t * 0.8, t * 0.3], -1)[:, None, None], (8, 16, 16, 2))
    dump = {"sample_locs": locs.astype(np.float32),
            "attention": rng.rand(8, 16, 16).astype(np.float32),
            "corr_pos": rng.randint(0, 16, (16, 16, 2)).astype(np.float32),
            "img": rng.randint(0, 255, (64, 64, 3), dtype=np.uint8),
            "other_img": rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)}
    path = tmp_path / "dump.pkl"
    path.write_bytes(pickle.dumps(dump))
    got = _run("torch_post_visualization.py", str(path), str(tmp_path / "p"), "--points",
               "3,5", "12,9").stdout
    want = _run("post_visualization.py", str(path), str(tmp_path / "j"), "--points",
                "3,5", "12,9").stdout
    assert got.replace(str(tmp_path / "p"), "OUT") == want.replace(str(tmp_path / "j"), "OUT")
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def test_undistort_script_against_jax(tmp_path):
    sys.path.insert(0, ROOT)
    from scripts.make_fake_h36m import make_split

    root = tmp_path / "data"
    make_split(str(root), "train", n_groups=1, image_size=120, seed=0, jpeg_quality=92,
               zips=False)
    anno = str(root / "h36m" / "annot" / "h36m_train.pkl")
    _run("torch_undistort_h36m.py", "--root", str(root), "--anno", anno, "--out",
         str(tmp_path / "port.zip"))
    _run("undistort_h36m.py", "--root", str(root), "--anno", anno, "--out",
         str(tmp_path / "jax.zip"))
    with zipfile.ZipFile(tmp_path / "port.zip") as zp, zipfile.ZipFile(tmp_path / "jax.zip") as zj:
        assert sorted(zp.namelist()) == sorted(zj.namelist()) and zp.namelist()
        diffs = []
        for name in zj.namelist():
            a = cv2.imdecode(np.frombuffer(zp.read(name), np.uint8), cv2.IMREAD_COLOR)
            b = cv2.imdecode(np.frombuffer(zj.read(name), np.uint8), cv2.IMREAD_COLOR)
            assert a.shape == b.shape
            diffs.append(np.abs(a.astype(int) - b.astype(int)))
    d = np.concatenate([x.ravel() for x in diffs])
    assert d.mean() < UNDISTORT_MEAN and d.max() <= UNDISTORT_MAX, (d.mean(), d.max())
