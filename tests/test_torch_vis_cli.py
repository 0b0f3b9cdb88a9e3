"""The VIS modes through the port's command line, against the JAX dispatch,
and the port's `entry()`.

The tiny flagship YAML of tests/test_torch_cli.py is evaluated by the
port's CLI on the CPU (DOTRAIN False, 2 view groups) with one VIS mode on;
the files it leaves (the frames, predictions.pkl, pck.pkl) are copied to a
second directory, where the JAX package's `visualization` runs on the JAX
config of the same YAML and overrides.  Each mode must produce the same
keys, with equal values (frame and pointcloud counts, the AUC, the
introspection dump's shapes), and the same files: auc.pkl's arrays equal,
the pointcloud pickles equal, and the video's frames, where the port
writes `<tag>.avi` (ROADMAP C23) and JAX `<tag>.mp4`, the same number read
back.  VIDEO_GT writes the ground-truth frames with no model run; its
dispatch then assembles nothing, as in JAX (its frames lie under
video_gt/).  EPIPOLAR_LINE runs with EPIPOLAR.ZRESIDUAL False: with it, the
z convolution's 256 channels cannot be added to the 5 heatmap channels, in
both packages.

`entry()` on the tiny flagship (CPU) gives, at the same weights (the
seeded builder), the same heatmaps, locations and scores as the port's
`build_model` and `predict` bit for bit; without a GPU and without a
device it raises.
"""

import ast
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from epipolar_transformers_tpu.config import load_config as jax_load_config
from epipolar_transformers_tpu.vis.visualization import visualization as jax_visualization
from epipolar_transformers_tpu_torch import main as cli
from epipolar_transformers_tpu_torch.config import DatasetCatalog, flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import trainer
from epipolar_transformers_tpu_torch.engine.tester import to_model_inputs
from epipolar_transformers_tpu_torch.graft_entry import entry
from epipolar_transformers_tpu_torch.vis.visualization import read_avi
from test_torch_cli import TINY_FLAGSHIP_YAML, TRAIN_SET
from torch_configs import one_torch_thread  # noqa: F401 (autouse)

MODES = {
    "video": ["VIS.VIDEO", "True"],
    "video_gt": ["VIS.VIDEO", "True", "VIS.VIDEO_GT", "True"],
    "epipolar_line": ["VIS.EPIPOLAR_LINE", "True", "EPIPOLAR.ZRESIDUAL", "False"],
    "auc": ["VIS.AUC", "True", "VIS.SAVE_PRED", "True"],
    "pointcloud": ["VIS.POINTCLOUD", "True", "VIS.SAVE_PRED", "True"],
}


@pytest.fixture
def yaml_path(tmp_path, monkeypatch):
    monkeypatch.setitem(DatasetCatalog.DATASETS, TRAIN_SET, {
        "factory": "SyntheticMultiview", "is_train": True, "n_samples": 8})
    path = tmp_path / "tiny_flagship.yaml"
    path.write_text(TINY_FLAGSHIP_YAML)
    return str(path)


def _vis_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("VIS: ")]
    assert len(lines) == 1, out[-2000:]
    return ast.literal_eval(lines[0][len("VIS: "):])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_vis_modes_match_the_jax_dispatch(yaml_path, tmp_path, capsys, mode):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    opts = ["DOTRAIN", "False", *MODES[mode]]
    cli.main(["--cfg", yaml_path, "--device", "cpu", "--max-eval-batches", "2", *opts,
              "OUTPUT_DIR", str(port_dir)])
    got = _vis_line(capsys.readouterr().out)
    shutil.copytree(port_dir, jax_dir, ignore=shutil.ignore_patterns("*.avi", "*.pkl")
                    if mode != "auc" and mode != "pointcloud" else shutil.ignore_patterns(
                        "*.avi", "auc.pkl", "pointclouds"))
    want = jax_visualization(jax_load_config(yaml_path, opts + ["OUTPUT_DIR", str(jax_dir)]))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "epipolar_introspection":
            assert got[k] == {kk: tuple(vv) for kk, vv in v.items()}
        else:
            assert got[k] == v, k
    if mode == "video":
        avi = read_avi(str(port_dir / "video" / "ds0.avi"))
        cap = cv2.VideoCapture(str(jax_dir / "video" / "ds0.mp4"))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert len(avi) == n == got["video/ds0"] == 2
        assert avi[0].shape == (64, 64, 3)  # 4 views of 32 px, 2 a row
    if mode == "video_gt":
        assert got == {} and sorted(os.listdir(port_dir / "video_gt" / "video" / "ds0")) == [
            f"view{v}" for v in range(4)]
    if mode == "epipolar_line":
        with open(port_dir / "epipolar_introspection.pkl", "rb") as f:
            dump = pickle.load(f)
        with open(jax_dir / "epipolar_introspection.pkl", "rb") as f:
            jdump = pickle.load(f)
        assert {k: v.shape for k, v in dump.items()} == {k: v.shape for k, v in jdump.items()}
        np.testing.assert_allclose(dump["sample_locs"], jdump["sample_locs"], atol=1e-4)
    if mode == "auc":
        a = pickle.loads((port_dir / "auc.pkl").read_bytes())
        b = pickle.loads((jax_dir / "auc.pkl").read_bytes())
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    if mode == "pointcloud":
        names = sorted(os.listdir(jax_dir / "pointclouds"))
        # VIS.SAVE_PRED_FREQ 100: the first group's prediction
        assert sorted(os.listdir(port_dir / "pointclouds")) == names == ["pointcloud_00000.pkl"]
        a = pickle.loads((port_dir / "pointclouds" / names[0]).read_bytes())
        b = pickle.loads((jax_dir / "pointclouds" / names[0]).read_bytes())
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_entry_matches_the_builder():
    # the synthetic train item draws its augmentation from numpy's global
    # generator, as the JAX entry's does
    np.random.seed(0)
    fn, args = entry("cpu", tiny=True)
    cfg = flagship_cfg(tiny=True)
    np.random.seed(0)
    batch = collate([SyntheticMultiview(cfg, is_train=True, n_samples=1)[0]])
    inputs = to_model_inputs(batch, "cpu")
    for got, name in zip(args, ("img", "other_img", "KRT", "other_KRT")):
        assert torch.equal(got, inputs[name]), name
    model = trainer.build_model(cfg, torch.device("cpu")).eval()
    with torch.inference_mode():
        want = model({k: inputs[k] for k in ("img", "other_img", "KRT", "other_KRT")})
    out = fn(*args)
    for got, name in zip(out, ("heatmap_pred", "batch_locs", "score_pred")):
        assert torch.equal(got, want[name]), name
    assert out[0].shape == (1, 5, 8, 8)


def test_entry_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(trainer.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        entry()
