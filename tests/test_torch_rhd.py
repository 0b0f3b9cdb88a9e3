"""The port's RHD path == the JAX package's, with no cv2 in the port.

  * `read_png` (data/image_io.py) is bit-equal to cv2.imread (its BGR
    flipped to RGB) on PNGs that cv2 writes, grey, RGB and RGBA, and on
    PNGs the port's `write_png` builds with each of the five row filters
    and a mix of them (which cv2 reads back as the image);
  * `resize_bilinear` agrees with cv2.resize INTER_LINEAR to 1e-5 on up-
    and down-scales;
  * `RHDDataset` eval items equal the JAX dataset's on
    tests/test_datasets.py's fixture, key by key, to 1e-5; its train noise
    comes from its own seeded generator; `collate` keeps the scalar keys;
  * the port's `test()` on that fixture gives JAX `_test_lifting`'s metrics
    to 1e-4; the TF-pickle import gives JAX `load_external_weights`'
    weights and outputs;
  * configs/lifting/{lifting_rot,lifting_direct,img_lifting_rot}.yaml train
    a step and evaluate through the port's command line on the CPU, on a
    fake RHD tree written without cv2, with finite EPEmean_can / EPEmean.
cv2 appears only here, on the JAX side and as the reference of the reader.
"""

import math
import os
import pickle

import cv2
import numpy as np
import pytest
import jax
import torch

from chip_smoke import write_fake_rhd, write_hand3d_pickle
from epipolar_transformers_tpu.config import DatasetCatalog as JDatasetCatalog
from epipolar_transformers_tpu.data.datasets.rhd import RHDDataset as JRHDDataset
from epipolar_transformers_tpu.data.pipeline import collate as jcollate
from epipolar_transformers_tpu.engine import create_train_state
from epipolar_transformers_tpu.engine.tester import test as jtest
from epipolar_transformers_tpu.engine.trainer import select_model_inputs
from epipolar_transformers_tpu.utils.pretrained import load_cfg_weights as jload_cfg_weights
from epipolar_transformers_tpu_torch.config import DatasetCatalog
from epipolar_transformers_tpu_torch.data.datasets.rhd import RHDDataset
from epipolar_transformers_tpu_torch.data.image_io import read_png, resize_bilinear, write_png
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine import test as port_test
from epipolar_transformers_tpu_torch.engine.tester import MODEL_KEYS, to_model_inputs
from epipolar_transformers_tpu_torch.main import main
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils.jax_import import jax_state_dict, load_jax_variables
from epipolar_transformers_tpu_torch.utils.pretrained import apply_pretrained
from test_datasets import _make_rhd_fixture
from test_torch_resnet import to_numpy_tree
from torch_configs import config_pair, one_torch_thread  # noqa: F401

RHD = {"LIFTING": {"ENABLED": True, "CROP_SIZE": 128, "IMAGE_SIZE": 320},
       "KEYPOINT": {"NUM_PTS": 21, "HEATMAP_SIZE": (32, 32), "SIGMA": 4.0},
       "DATASET_FAMILY": "rhd"}


def _rgb(bgr):
    """cv2's channel order -> the file's."""
    return bgr if bgr.ndim == 2 else bgr[..., [2, 1, 0, 3][:bgr.shape[2]]]


def _image(rng, shape):
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    ramp = (np.arange(shape[1]) * 3 % 256).astype(np.uint8)
    img[: shape[0] // 2] = ramp[None, :, None] if len(shape) == 3 else ramp[None]
    return img


@pytest.mark.parametrize("shape", [(40, 56, 3), (40, 56), (33, 21, 4)], ids=["rgb", "grey", "rgba"])
def test_read_png_equals_cv2_on_cv2_pngs(tmp_path, shape):
    img = _image(np.random.RandomState(len(shape)), shape)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _rgb(img))  # cv2 takes BGR(A)
    got = read_png(path)
    assert got.dtype == np.uint8
    assert np.array_equal(got, img)
    assert np.array_equal(got, _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 0, 3, 1, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png_undoes_every_filter(tmp_path, filters):
    rng = np.random.RandomState(sum(filters))
    for shape in ((24, 31, 3), (17, 9), (12, 13, 4)):
        img = _image(rng, shape)
        path = str(tmp_path / "f.png")
        write_png(path, img, filters)
        assert np.array_equal(_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img)
        assert np.array_equal(read_png(path), img)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    """16-bit PNGs are read since the depth maps need them
    (tests/test_torch_utils_extra.py); a 1-bit one is refused."""
    path = str(tmp_path / "bilevel.png")
    cv2.imwrite(path, np.zeros((4, 4), np.uint8), [cv2.IMWRITE_PNG_BILEVEL, 1])
    with pytest.raises(ValueError, match="bit depth 1,"):
        read_png(path)


@pytest.mark.parametrize("src,size", [((83, 61, 3), (256, 256)), ((83, 61, 3), (20, 30)),
                                      ((100, 100), (50, 50)), ((37, 45, 3), (128, 128)),
                                      ((200, 120, 3), (64, 96))],
                         ids=["up", "down", "half", "up_square", "mixed"])
def test_resize_bilinear_matches_cv2(src, size):
    x = np.random.RandomState(0).rand(*src).astype(np.float32) - 0.5
    got = resize_bilinear(x, size)
    want = cv2.resize(x, size, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return _make_rhd_fixture(tmp_path_factory.mktemp("rhd"), n=3)


def test_rhd_eval_items_match_jax(fixture_root):
    for task in ("lifting_rot", "lifting_direct"):
        cfg, jcfg = config_pair({**RHD, "DATASETS": {"TASK": task},
                                 "LIFTING": {**RHD["LIFTING"], "FLIP_ON": task == "lifting_rot"}})
        ds = RHDDataset(cfg, fixture_root, "training", is_train=False)
        jds = JRHDDataset(jcfg, fixture_root, "training", is_train=False)
        assert len(ds) == len(jds) == 3
        for i in range(3):
            got, want = ds[i], jds[i]
            assert list(got) == list(want)
            for k in want:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def test_rhd_train_noise_comes_from_its_own_generator(fixture_root):
    cfg, _ = config_pair({**RHD, "DATASETS": {"TASK": "lifting_rot"}})
    state = np.random.get_state()
    a, b = (RHDDataset(cfg, fixture_root, "training", is_train=True, seed=5) for _ in range(2))
    c = RHDDataset(cfg, fixture_root, "training", is_train=True, seed=6)
    first, again = [a[0], a[0]], [b[0], b[0]]  # each draw moves the generator
    for k in first[0]:
        assert np.array_equal(first[0][k], again[0][k]) and np.array_equal(first[1][k],
                                                                           again[1][k]), k
    assert not np.array_equal(first[0]["heatmap"], first[1]["heatmap"])
    assert not np.array_equal(first[0]["heatmap"], c[0]["heatmap"])
    assert np.array_equal(np.random.get_state()[1], state[1])


def test_collate_keeps_the_scalar_keys(fixture_root):
    cfg, jcfg = config_pair({**RHD, "DATASETS": {"TASK": "lifting_rot"}})
    items = [RHDDataset(cfg, fixture_root, "training")[i] for i in range(3)]
    got = collate(items)
    want = jcollate(items)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
    assert got["hand-side"].dtype == np.int32 and got["hand-side"].shape == (3,)
    assert got["scale"].shape == got["unit"].shape == (3,)
    inputs = to_model_inputs(got, torch.device("cpu"), MODEL_KEYS)
    assert inputs["heatmap"].shape == (3, 21, 32, 32) and inputs["hand-side"].shape == (3,)


@pytest.mark.parametrize("task", ["lifting_direct", "lifting_rot"])
def test_port_test_matches_jax_test_lifting(tmp_path, monkeypatch, fixture_root, task):
    """Both packages' `test` on the fixture served as `rhd_val`, the port's
    model carrying the JAX state's weights; SAVE_PRED writes one pair a
    sample."""
    data_dir = tmp_path / "datasets"
    dst = data_dir / "RHD_published_v2" / "evaluation"
    dst.mkdir(parents=True)
    for kind in ("color", "mask"):
        os.symlink(os.path.join(fixture_root, "training", kind), dst / kind)
    os.link(os.path.join(fixture_root, "training", "anno_training.pickle"),
            dst / "anno_evaluation.pickle")
    for catalog in (DatasetCatalog, JDatasetCatalog):
        monkeypatch.setattr(catalog, "DATA_DIR", str(data_dir))
    cfg, jcfg = config_pair({**RHD, "DATASETS": {"TASK": task, "TEST": ("RHD_val",)},
                             "TEST": {"IMS_PER_BATCH": 2},
                             "VIS": {"SAVE_PRED": True, "SAVE_PRED_FREQ": 1},
                             "OUTPUT_DIR": str(tmp_path / "out")})
    ds = RHDDataset(cfg, str(data_dir / "RHD_published_v2"), "evaluation")
    inputs = select_model_inputs(jcfg, jcollate([ds[i] for i in range(2)]))
    state = create_train_state(jcfg, jax.random.PRNGKey(0), inputs)
    want = jtest(jcfg.replace(VIS=jcfg.VIS.replace(SAVE_PRED=False)), state)
    model = ModelBuilder(cfg)
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})
    got = port_test(cfg, model)
    assert set(got) == set(want) and "EPEmean_can" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    with open(tmp_path / "out" / "predictions.pkl", "rb") as f:
        pairs = pickle.load(f)
    assert len(pairs) == 3 and pairs[0][1]["can_pred"].shape == (21, 3)
    assert set(pairs[0][0]) == set(ds[0])


@pytest.mark.parametrize("task", ["lifting", "lifting_rot"])
def test_tf_pickle_import_matches_jax(tmp_path, task):
    """cfg.WEIGHTS = a TF pickle: the port's imported weights are JAX's,
    carried across (its fc0 rows permuted to the NCHW flatten), and the
    outputs agree."""
    path = str(tmp_path / "hand3d.pickle")
    write_hand3d_pickle(path, np.random.RandomState(4), hw=2 * 2, side=2)
    cfg, jcfg = config_pair({**RHD, "DATASETS": {"TASK": task}, "WEIGHTS": path,
                             "KEYPOINT": {**RHD["KEYPOINT"], "HEATMAP_SIZE": (128, 128)}})
    rng = np.random.RandomState(5)
    batch = {"heatmap": rng.rand(2, 128, 128, 21).astype(np.float32),
             "hand-side": np.array([1, 0], np.int32),
             "visibility": np.ones((2, 21), np.float32),
             "can-points-3d": rng.randn(2, 21, 3).astype(np.float32),
             "normed-points-3d": rng.randn(2, 21, 3).astype(np.float32),
             "rotation": np.stack([np.eye(3, dtype=np.float32)] * 2)}
    from epipolar_transformers_tpu.models import ModelBuilder as JModelBuilder

    jmodel = JModelBuilder(jcfg)
    variables = jax.jit(lambda k: jmodel.init(k, batch, is_train=False))(jax.random.PRNGKey(0))
    imported, done = jload_cfg_weights(jcfg, variables)
    assert done
    model = ModelBuilder(cfg)
    load_jax_variables(model, variables)
    assert apply_pretrained(cfg, model)
    want = jax_state_dict(model, to_numpy_tree(imported))[0]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not torch.equal(model.liftingnet.conv1[0].weight,
                           ModelBuilder(cfg).liftingnet.conv1[0].weight)
    got = model.eval()(to_model_inputs(batch, torch.device("cpu"), MODEL_KEYS))[2]
    jout = jmodel.apply(imported, batch, is_train=False)[2]
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("recipe", ["lifting_rot", "lifting_direct", "img_lifting_rot"])
def test_lifting_recipe_through_the_command_line(tmp_path, monkeypatch, recipe):
    """The recipe as written (its task, loss, optimizer and widths; R-50 for
    img_lifting_rot), cut to batch 2, 64 px crops, one train step and one
    eval batch, on a fake RHD tree that the port's own PNG writer made."""
    write_fake_rhd(str(tmp_path / "datasets"), n_items=2)
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", str(tmp_path / "datasets"))
    results = main(["--cfg", f"configs/lifting/{recipe}.yaml", "--device", "cpu",
                    "--max-steps", "1", "--max-eval-batches", "1",
                    "SOLVER.IMS_PER_BATCH", "2", "TEST.IMS_PER_BATCH", "2",
                    "LIFTING.CROP_SIZE", "64", "OUTPUT_DIR", str(tmp_path / "out")])
    keys = {"EPEmean_can", "loss"} | ({"EPEmean", "rot_loss", "xyz_loss"} if "rot" in recipe
                                      else set())
    assert set(results) == keys
    assert all(math.isfinite(v) for v in results.values()), results
