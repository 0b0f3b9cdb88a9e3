"""DATALOADER.DEVICE_RENDER in the port: ops/synthetic_render.py against the
JAX renderer on the same coordinates and against the port's host render of
the same items (atol 2e-5, as tests/test_device_render.py holds the JAX
package), and the train loop from coordinates-only batches.

The config is the flagship recipe's rig (configs/epipolar/
synthetic_zresidual_flagship.yaml: scale/rotation augmentation, sigma 8,
DEVICE_RENDER on) cut to 64 px, 16x16 heatmaps, 5 joints and the tiny R-18.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from epipolar_transformers_tpu.ops.synthetic_render import make_batch_renderer as jrenderer
from epipolar_transformers_tpu_torch.config import load_config
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate, make_train_loader
from epipolar_transformers_tpu_torch.engine.trainer import build_model, model_inputs, train
from epipolar_transformers_tpu_torch.ops.synthetic_render import (RENDER_PARAM_KEYS,
                                                                   make_batch_renderer)
from torch_configs import config_pair, one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
ATOL = 2e-5
BATCH = 4


def _cfgs(device_render: bool):
    """(port config, JAX config)."""
    d = {
        "DATASETS": {"IMAGE_SIZE": (64, 64), "SCALE_FACTOR": 0.25, "ROT_FACTOR": 30},
        "KEYPOINT": {"HEATMAP_SIZE": (16, 16), "SIGMA": 8.0},
        "SOLVER": {"IMS_PER_BATCH": BATCH, "MAX_EPOCHS": 1},
        "DATALOADER": {"DEVICE_RENDER": device_render},
        "TENSORBOARD": {"USE": False},
        "OUTPUT_DIR": "",
    }
    return config_pair(d, tiny_flagship=True)


def _cfg(device_render: bool):
    return _cfgs(device_render)[0]


def _items(device_render: bool, n=BATCH):
    np.random.seed(11)  # the reference view and the augmentation draw from it
    ds = SyntheticMultiview(_cfg(device_render), is_train=True, n_samples=8, seed=3)
    assert ds.device_render == device_render
    return collate([ds[i] for i in range(n)])


def test_device_render_matches_jax_and_host():
    host, light = _items(False), _items(True)
    assert "img" not in light and set(RENDER_PARAM_KEYS) <= set(light)
    np.testing.assert_array_equal(host["points-2d"], light["points-2d"])
    cfg, jcfg = _cfgs(True)
    got = make_batch_renderer(cfg)(
        {k: torch.from_numpy(light[k]) for k in ("KRT", "visibility", *RENDER_PARAM_KEYS)})
    assert not set(RENDER_PARAM_KEYS) & set(got)
    want = jrenderer(jcfg)({k: jnp.asarray(light[k]) for k in ("visibility", *RENDER_PARAM_KEYS)})
    for k in ("img", "other_img", "heatmap"):
        t = got[k]
        assert t.dtype == torch.float32 and t.permute(0, 2, 3, 1).is_contiguous(), k
        nhwc = t.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(nhwc, np.asarray(want[k]), rtol=0, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(nhwc, host[k], rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(got["KRT"].numpy(), host["KRT"])


def test_model_inputs_upload_only_the_render_keys():
    batch = _items(True)
    inputs = model_inputs(batch, CPU, make_batch_renderer(_cfg(True)))
    assert set(inputs) == {"img", "other_img", "heatmap", "KRT", "other_KRT", "visibility",
                           "camera", "other_camera"}
    assert inputs["img"].shape == (BATCH, 3, 64, 64)
    assert inputs["heatmap"].shape == (BATCH, 5, 16, 16)


def test_first_step_loss_with_and_without_device_render():
    """The same seed gives the same batch either way; the first step's
    loss agrees within 1e-5 relative."""
    model = build_model(_cfg(False), CPU)  # train-mode BN: the loss reads batch statistics
    losses = []
    for device_render in (False, True):
        cfg = _cfg(device_render)
        np.random.seed(cfg.SEED)
        batch = next(iter(make_train_loader(cfg)))
        with torch.no_grad():
            losses.append(model(model_inputs(batch, CPU, make_batch_renderer(cfg)))[0]["loss"].item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_train_from_coordinates_only_batches(tmp_path):
    cfg = _cfg(True).replace(OUTPUT_DIR=str(tmp_path))
    model, optimizer = train(cfg, max_steps=2, device="cpu")
    assert optimizer.count == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("yaml,joints,size,heatmap", [
    ("configs/epipolar/synthetic_zresidual_flagship.yaml", 17, 256, 64),
    ("configs/epipolar/synthetic_hg.yaml", 5, 64, 16)], ids=["flagship", "hg"])
def test_recipes_render_on_the_device(yaml, joints, size, heatmap):
    """Both recipes set DATALOADER.DEVICE_RENDER: their train items carry
    coordinates only, and the trainer's inputs come out at the recipe's
    sizes, images in [0, 1], each visible joint with a target peak (above
    exp(-1) at sigma 2 on a 4-px grid), each hidden one none."""
    cfg = load_config(yaml)
    np.random.seed(0)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=2)
    batch = collate([ds[0], ds[1]])
    assert cfg.DATALOADER.DEVICE_RENDER and "img" not in batch
    inputs = model_inputs(batch, CPU, make_batch_renderer(cfg))
    assert inputs["img"].shape == inputs["other_img"].shape == (2, 3, size, size)
    assert inputs["heatmap"].shape == (2, joints, heatmap, heatmap)
    assert 0 <= float(inputs["img"].min()) and float(inputs["img"].max()) <= 1
    peaks = inputs["heatmap"].amax(dim=(2, 3))
    visible = torch.from_numpy(batch["visibility"]) > 0
    assert float(peaks[visible].min()) > 0.35 and not peaks[~visible].any()
