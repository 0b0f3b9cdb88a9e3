"""The H36M slice as a whole, on the CPU, on the tree that
scripts/make_fake_h36m.py's `make_split` writes (200 px frames).

The port's command line trains configs/epipolar/fake_h36m_zresidual.yaml
for 2 steps and tests 1 view group, cut to a tiny width (R-18, 64 px,
16x16 heatmaps, K=8, batch 2) with 2 loader workers, and its RESULTS are
finite.  Then one train step of the tiny flagship on a batch of the port's
loader against the JAX train step on the JAX loader's batch, both in f64 as
tests/test_torch_train_step.py takes them, to its tolerances: the loss
(rtol 1e-5) and every gradient (rtol 1e-4, atol 1e-4 x its max).
"""

import math

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from scripts.make_fake_h36m import make_split  # noqa: E402
from test_torch_train_step import ZERO_GRAD, train_step_pair  # noqa: E402
from torch_configs import config_pair, one_torch_thread  # noqa: E402,F401

from epipolar_transformers_tpu.data import pipeline as jax_pipeline  # noqa: E402
from epipolar_transformers_tpu.data.datasets.multiview_h36m import MultiViewH36M as JaxH36M  # noqa: E402
from epipolar_transformers_tpu_torch.config import DatasetCatalog  # noqa: E402
from epipolar_transformers_tpu_torch.data.datasets.multiview_h36m import MultiViewH36M  # noqa: E402
from epipolar_transformers_tpu_torch.data.pipeline import TrainLoader  # noqa: E402

BATCH = 4


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fakeh36m"))
    make_split(root, "train", n_groups=BATCH, image_size=200, seed=0, jpeg_quality=92, zips=True)
    make_split(root, "validation", n_groups=2, image_size=200, seed=7919, jpeg_quality=92,
               zips=True)
    return root


def test_cli_trains_and_tests_on_h36m(fake_root, tmp_path, monkeypatch):
    from epipolar_transformers_tpu_torch.main import main

    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", fake_root)
    results = main([
        "--cfg", "configs/epipolar/fake_h36m_zresidual.yaml", "--device", "cpu",
        "--max-steps", "2", "--max-eval-batches", "1",
        "BACKBONE.BODY", "epipolarposeR-18", "DATASETS.IMAGE_SIZE", "(64, 64)",
        "KEYPOINT.HEATMAP_SIZE", "(16, 16)", "EPIPOLAR.SAMPLESIZE", "8",
        "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "2",
        "OUTPUT_DIR", str(tmp_path / "out")])
    assert {"EPEmean_global", "JDR", "PCK@10"} <= set(results)
    assert all(math.isfinite(v) for v in results.values()), results


def test_train_step_on_loader_batch_matches_jax(fake_root):
    h36m = {"DATASETS": {"TRAIN": ("multiview_h36m_train",), "DATA_FORMAT": "jpg",
                         "H36M": {"MAPPING": False, "TRAIN_SAMPLE": 0}},
            "KEYPOINT": {"NUM_PTS": 17},
            "SOLVER": {"OPTIMIZER": "sgd", "BASE_LR": 0.1, "IMS_PER_BATCH": BATCH}}
    cfg, jcfg = config_pair(h36m, tiny_flagship=True)
    jcfg = jcfg.replace(EPIPOLAR=jcfg.EPIPOLAR.replace(ATTENTION_IMPL="reference"))
    anno = fake_root + "/h36m/annot/h36m_train.pkl"
    batch = next(iter(TrainLoader(MultiViewH36M(cfg, fake_root, anno, True, seed=cfg.SEED),
                                  BATCH, seed=cfg.SEED)))
    np.random.seed(jcfg.SEED)
    jbatch = next(iter(jax_pipeline.DataLoader(JaxH36M(jcfg, fake_root, anno, True), BATCH,
                                               shuffle=True, seed=jcfg.SEED, prefetch=0)))
    np.testing.assert_array_equal(batch["img"], jbatch["img"])
    step = train_step_pair(cfg, jcfg, batch, jbatch)

    np.testing.assert_allclose(step["loss_dict"]["loss"].item(), step["jloss"], rtol=1e-5)
    scale = max(float(np.abs(g.numpy()).max()) for g in step["jgrads"].values())
    for name, got in step["grads"].items():
        want = step["jgrads"][name].numpy()
        if name == ZERO_GRAD:
            assert max(np.abs(want).max(), got.abs().max().item()) < 1e-5 * scale, name
            continue
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)
