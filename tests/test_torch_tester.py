"""The port's eval engine == the JAX package's, on the tiny flagship
(`flagship_cfg(tiny=True)`: epipolarposeR-18, 32 px, 8x8 heatmaps, 5
joints, K=4, f32) with shared randomized weights (as in
test_torch_slice.py, the zero-init BN's scale included) and the synthetic
rig's first two view groups.  TEST.EPEMEAN_MAX_DIST is raised to 1e6 so
that the random net's errors are not all clamped to one value.

(i)   The JAX eval outputs of the two groups, fed to the port's
      `process_group`, give the JAX `test()` metrics in each of the five
      non-RPSM modes to rtol 1e-9: the host half is the same numpy.
(ii)  The port's `test` on the CPU against the JAX `test`: the same keys,
      the values within rtol 1e-3 (measured worst: 1.6e-8, pymvg's MPJPE;
      the 2D metrics are equal).  The forwards agree to ~1e-5 px
      (test_torch_slice.py), and these inputs put no joint at a PCK
      threshold or a JDR argmax tie.
(iii) TEST.TRAIN_BN and TEST.RECOMPUTE_BN against JAX, the metrics at (ii)'s
      tolerance (measured worst: 4.4e-7 and 4.4e-8, MPJPE) and the running statistics after `recompute_bn` at the
      train step's (rtol 1e-5, atol 1e-5 x max); TRAIN_BN leaves the
      running statistics as they were, and `test` restores them after
      RECOMPUTE_BN.
(iv)  The SAVE_PRED pickle has the JAX keys and shapes; `pck.pkl` exists.
(v)   Double-buffered and serial drives give bit-equal results.
(vi)  TEST.IMS_PER_BATCH > 1 evaluates the first group of each batch, as
      the JAX tester does.
(vii) VIS.VIDEO / VIDEO_GT dump the JAX tester's frames (the raster within
      a pixel).

The JAX eval forward is compiled once (`make_eval_step`) and reused by
every JAX `test` of the file; JAX `test` with RECOMPUTE_BN is `test` on the
state that `recompute_bn` returns, which is what it runs.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from epipolar_transformers_tpu.engine import tester as jtester
from epipolar_transformers_tpu.engine.trainer import TrainState
from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import EvalLoader, make_eval_loaders
from epipolar_transformers_tpu_torch.engine import tester
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from test_torch_resnet import randomize_variables, to_numpy_tree
from torch_configs import config_pair, one_torch_thread  # noqa: F401 (autouse)

GROUPS = 2
MODES = ("naive", "refine", "pymvg", "epipolar", "epipolar_dlt")
BASE = {"TEST": {"IMS_PER_BATCH": 1, "EPEMEAN_MAX_DIST": 1e6},
        "KEYPOINT": {"TRIANGULATION": "pymvg"}}
JAX_INPUT_KEYS = ("img", "KRT", "other_img", "other_KRT", "camera", "other_camera",
                  "heatmap", "visibility")
METRIC_RTOL = 1e-3


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a[k], v) if isinstance(v, dict) and k in a else v
    return out


def _cfgs(d=None):
    """(port config, JAX config): the tiny flagship with BASE, then `d`."""
    return config_pair(_merge(BASE, d or {}), tiny_flagship=True)


class JaxSide:
    """The JAX state, its compiled eval forward, and the outputs and groups
    that the port is held to."""

    def __init__(self):
        cfg, jcfg = _cfgs()
        ds = SyntheticMultiview(cfg, is_train=False, n_samples=GROUPS)
        self.groups = [{k: v[0] for k, v in b.items()} for b in EvalLoader(ds)]
        jmodel = JModelBuilder(jcfg)
        inputs0 = {k: jnp.asarray(self.groups[0][k]) for k in ("img", "KRT", "other_img",
                                                               "other_KRT")}
        variables = jax.jit(lambda k: jmodel.init(k, inputs0, is_train=False))(
            jax.random.PRNGKey(0))
        rng = np.random.RandomState(0)
        self.variables = randomize_variables(to_numpy_tree(variables), rng)
        bn = self.variables["params"]["reference"]["epipolar_sampler"]["bn"]["norm"]
        bn["scale"] = rng.randn(*bn["scale"].shape).astype(np.float32)
        self.state = TrainState.create(apply_fn=jmodel.apply, params=self.variables["params"],
                                       tx=optax.sgd(0.0),
                                       batch_stats=self.variables["batch_stats"])
        self.step = jtester.make_eval_step(jcfg, self.state)
        self.outputs = [
            {k: np.asarray(v) for k, v in self.step(
                self.state.params, self.state.batch_stats,
                {k: g[k] for k in JAX_INPUT_KEYS}).items()}
            for g in self.groups]

    def test(self, jcfg, state=None, max_batches=GROUPS):
        """JAX `test`, its eval forward the compiled one unless TRAIN_BN."""
        make = jtester.make_eval_step
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtester, "make_eval_step",
                       lambda c, s, train_bn=False: make(c, s, True) if train_bn else self.step)
            return jtester.test(jcfg, state or self.state, max_batches=max_batches)


@pytest.fixture(scope="module")
def jax_side():
    return JaxSide()


@pytest.fixture(scope="module")
def model(jax_side):
    cfg, _ = _cfgs()
    model = ModelBuilder(cfg)
    load_jax_variables(model, jax_side.variables)
    return model.eval()


def _port_layout(jout):
    """JAX eval outputs in the port's layout: heatmaps NCHW."""
    return {**jout, "heatmap_pred": jout["heatmap_pred"].transpose(0, 3, 1, 2)}


def _assert_metrics_close(got, want, rtol):
    assert set(got) == set(want)
    assert {"EPEmean_global", "MPJPE@action0", "JDR", "PCK@1"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_host_half_matches_jax(jax_side, mode):
    cfg, jcfg = _cfgs({"KEYPOINT": {"TRIANGULATION": mode}})
    record = tester.EvalRecord()
    for ib, (group, jout) in enumerate(zip(jax_side.groups, jax_side.outputs)):
        tester.process_group(cfg, group, _port_layout(jout), record, ib)
    _assert_metrics_close(record.meters.get_all_avg(), jax_side.test(jcfg), rtol=1e-9)
    assert len(record.err_joints) == GROUPS


@pytest.mark.parametrize("mode", ["pymvg", "epipolar_dlt"])
def test_port_test_matches_jax(jax_side, model, mode):
    cfg, jcfg = _cfgs({"KEYPOINT": {"TRIANGULATION": mode}})
    got = tester.test(cfg, model, max_batches=GROUPS)
    _assert_metrics_close(got, jax_side.test(jcfg), rtol=METRIC_RTOL)
    assert got["EPEmean_global"] < 1e6  # not clamped


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def test_train_bn_matches_jax(jax_side, model):
    cfg, jcfg = _cfgs({"TEST": {"TRAIN_BN": True}})
    before = _running_stats(model)
    got = tester.test(cfg, model, max_batches=GROUPS)
    for k, v in _running_stats(model).items():
        assert torch.equal(v, before[k]), k
    want = jax_side.test(jcfg)
    _assert_metrics_close(got, want, rtol=METRIC_RTOL)
    assert got != tester.test(_cfgs()[0], model, max_batches=GROUPS)


def test_recompute_bn_matches_jax(jax_side, model):
    cfg, jcfg = _cfgs({"TEST": {"RECOMPUTE_BN": True}})
    before = _running_stats(model)
    got = tester.test(cfg, model, max_batches=GROUPS)
    for k, v in _running_stats(model).items():
        assert torch.equal(v, before[k]), k  # restored after the test

    jstate = jtester.recompute_bn(jcfg, jax_side.state, GROUPS)
    _assert_metrics_close(got, jax_side.test(_cfgs()[1], jstate), rtol=METRIC_RTOL)
    want, _ = jax_state_dict(model, to_numpy_tree(
        {"params": jax_side.variables["params"], "batch_stats": jstate.batch_stats}))
    tester.recompute_bn(cfg, model, GROUPS)
    try:
        moved = 0
        for k, v in _running_stats(model).items():
            w = want[k].numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()), err_msg=k)
            moved += not torch.equal(v, before[k])
        assert moved > 40
    finally:
        model.load_state_dict({**model.state_dict(), **before})


def test_save_pred_pickles_match_jax(jax_side, model, tmp_path):
    d = {"VIS": {"SAVE_PRED": True, "SAVE_PRED_FREQ": 1}}
    cfg, _ = _cfgs({**d, "OUTPUT_DIR": str(tmp_path / "port")})
    _, jcfg = _cfgs({**d, "OUTPUT_DIR": str(tmp_path / "jax")})
    tester.test(cfg, model, max_batches=GROUPS)
    jax_side.test(jcfg)
    for name in ("predictions.pkl", "pck.pkl"):
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        if name == "pck.pkl":
            got, want = [got], [want]
        assert len(got) == len(want) == (GROUPS if name == "predictions.pkl" else 1)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert np.shape(g[k]) == np.shape(w[k]), (name, k)
    assert os.path.exists(tmp_path / "port" / "pck.pkl")


def test_double_buffered_drive_equals_serial(model, tmp_path):
    results = []
    for double, sub in ((True, "a"), (False, "b")):
        cfg, _ = _cfgs({"KEYPOINT": {"TRIANGULATION": "epipolar"},
                        "VIS": {"SAVE_PRED": True, "SAVE_PRED_FREQ": 1},
                        "OUTPUT_DIR": str(tmp_path / sub)})
        metrics = tester.test(cfg, model, max_batches=3, double_buffer=double)
        with open(tmp_path / sub / "predictions.pkl", "rb") as f:
            results.append((metrics, pickle.load(f)))
    (m1, p1), (m2, p2) = results
    assert m1 == m2 and len(p1) == len(p2) == 3
    for a, b in zip(p1, p2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_ims_per_batch_takes_the_first_group(jax_side, model):
    cfg, jcfg = _cfgs({"TEST": {"IMS_PER_BATCH": 2}})
    sizes = [len(b["img"]) for b in EvalLoader(SyntheticMultiview(cfg, False, n_samples=5), 2)]
    assert sizes == [2, 2, 1]  # in order, the last partial batch kept
    assert [len(ld) for ld in make_eval_loaders(cfg)] == [128]
    got = tester.test(cfg, model, max_batches=2)
    _assert_metrics_close(got, jax_side.test(jcfg), rtol=METRIC_RTOL)
    # groups 0 and 2, not 0 and 1
    assert got != tester.test(_cfgs()[0], model, max_batches=2)


@pytest.mark.parametrize("override,subdir", [
    ({"VIS": {"VIDEO": True}}, "video"),
    ({"VIS": {"VIDEO_GT": True}}, "video_gt/video"),
], ids=["video", "video_gt"])
def test_unported_eval_modes_raise(jax_side, model, tmp_path, override, subdir):
    """VIS.VIDEO and VIDEO_GT, which raised before the port had them, now
    dump the frames the JAX tester dumps: the same files, and in each frame
    the pixels drawn over the undrawn view (a skeleton in both) lie each
    within a 1-px dilation of the other's, with every pixel farther from
    either bit-equal (tests/test_torch_vis.py's raster check); VIDEO_GT runs
    no model and gives no metrics, VIDEO the metrics of (ii)."""
    from scipy import ndimage

    from epipolar_transformers_tpu_torch.vis.visualization import read_frame, render_pose_frame

    cfg, jcfg = _cfgs(override)
    got = tester.test(cfg.replace(OUTPUT_DIR=str(tmp_path / "port")), model, max_batches=GROUPS)
    want = jax_side.test(jcfg.replace(OUTPUT_DIR=str(tmp_path / "jax")))
    assert set(got) == set(want)
    if subdir.startswith("video_gt"):
        assert got == want == {}
    root_p, root_j = tmp_path / "port" / subdir / "ds0", tmp_path / "jax" / subdir / "ds0"
    views = sorted(os.listdir(root_j))
    assert sorted(os.listdir(root_p)) == views and len(views) == 4
    groups = [b["img"][0] for _, b in zip(range(GROUPS), make_eval_loaders(cfg)[0])]
    dilate = np.ones((3, 3), bool)
    for v, view in enumerate(views):
        names = sorted(os.listdir(root_j / view))
        assert sorted(os.listdir(root_p / view)) == names == [f"{i:08d}.png" for i in range(GROUPS)]
        for i, name in enumerate(names):
            a, b = read_frame(str(root_p / view / name)), read_frame(str(root_j / view / name))
            base = render_pose_frame(groups[i][v], np.zeros((0, 2)))
            assert a.shape == b.shape == base.shape
            da, db = (a != base).any(-1), (b != base).any(-1)
            assert da.any() and db.any()
            assert (da <= ndimage.binary_dilation(db, dilate)).all()
            assert (db <= ndimage.binary_dilation(da, dilate)).all()
            far = ~ndimage.binary_dilation(da | db, dilate)
            np.testing.assert_array_equal(a[far], b[far])
