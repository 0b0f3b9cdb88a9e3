"""The port's H36M data path against the JAX package's, on the tree that
scripts/make_fake_h36m.py's `make_split` writes (200 px frames, as
tests/test_fake_h36m.py builds it).

Items of MultiViewH36M and H36MDataset, key by key, in the three
DATA_FORMATs, at test time and at train time with the same seed (the port's
dataset seeded as numpy's global generator on the JAX side): every key
bit-equal but the heatmaps, to 1e-5 (the JAX package's native expf against
numpy's exp; the decode, the undistortion and the warp are bit-equal).
Then FILTER_DAMAGE, TRAIN/TEST_SAMPLE, MAPPING, TOPK 1/2/3, NUM_CAM,
REAL3D and `evaluate`'s JDR; the loader's batches with 0 and 2 workers
against the JAX `DataLoader`'s; `IterationBasedBatchSampler`; a worker's
error stopping the run; MPII and Mixed items on tests/test_remaining_paths.py's
MPII fixture; and `chip_smoke.write_fake_h36m` against `make_split`.
"""

import json
import os
import pickle

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from scripts.make_fake_h36m import make_split  # noqa: E402
from tests.torch_configs import config_pair, one_torch_thread  # noqa: E402,F401

from epipolar_transformers_tpu.data import pipeline as jax_pipeline  # noqa: E402
from epipolar_transformers_tpu.data import samplers as jax_samplers  # noqa: E402
from epipolar_transformers_tpu.data.datasets import mpii as jax_mpii  # noqa: E402
from epipolar_transformers_tpu.data.datasets import multiview_h36m as jax_h36m  # noqa: E402
from epipolar_transformers_tpu_torch.data import pipeline  # noqa: E402
from epipolar_transformers_tpu_torch.data.datasets import mpii, multiview_h36m  # noqa: E402
from epipolar_transformers_tpu_torch.data.samplers import IterationBasedBatchSampler  # noqa: E402

HEATMAP_ATOL = 1e-5
SEED = 5


def h36m_dict(fmt="jpg", **h36m):
    return {
        "DATASETS": {"TASK": "multiview_keypoint", "IMAGE_SIZE": (64, 64), "DATA_FORMAT": fmt,
                     "H36M": {"MAPPING": False, "FILTER_DAMAGE": True, "REAL3D": False,
                              "TRAIN_SAMPLE": 0, "TEST_SAMPLE": 0, **h36m}},
        "BACKBONE": {"DOWNSAMPLE": 4},
        "KEYPOINT": {"NUM_PTS": 17, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
        "EPIPOLAR": {"TOPK": 1},
    }


def merged(d, **sections):
    out = {k: dict(v) for k, v in d.items()}
    for k, v in sections.items():
        out[k] = {**out.get(k, {}), **v}
    return out


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    """3 train groups (subject 1) and 12 validation groups (subject 9, so
    group 11, action 13 subaction 1, is damaged)."""
    root = str(tmp_path_factory.mktemp("fakeh36m"))
    make_split(root, "train", n_groups=3, image_size=200, seed=0, jpeg_quality=92, zips=True)
    make_split(root, "validation", n_groups=12, image_size=200, seed=7919, jpeg_quality=92,
               zips=True)
    return root


def anno(root, train):
    return os.path.join(root, "h36m", "annot",
                        "h36m_train.pkl" if train else "h36m_validation.pkl")


def pair(root, d, train, cls="MultiViewH36M", seed=SEED):
    """(port dataset, JAX dataset) of the same config and tree; the port's
    draws seeded with `seed`, the JAX side's global generator too."""
    cfg, jcfg = config_pair(d)
    port = getattr(multiview_h36m, cls)(cfg, root, anno(root, train), is_train=train, seed=seed)
    ref = getattr(jax_h36m, cls)(jcfg, root, anno(root, train), is_train=train)
    np.random.seed(seed)
    return port, ref


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if "heatmap" in k:
            np.testing.assert_allclose(g, w, rtol=0, atol=HEATMAP_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("fmt", ["jpg", "zip", "undistoredzip"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cls", ["MultiViewH36M", "H36MDataset"])
def test_items_equal_jax(fake_root, fmt, train, cls):
    port, ref = pair(fake_root, h36m_dict(fmt), train, cls)
    assert len(port) == len(ref)
    for i in range(min(len(ref), 3)):  # the draws run on from item to item
        assert_items_equal(port[i], ref[i])


@pytest.mark.parametrize("case", ["mapping", "topk2", "topk3", "train_sample", "rpsm"])
def test_train_options_equal_jax(fake_root, case):
    d = h36m_dict()
    if case == "mapping":
        d = merged(h36m_dict(MAPPING=True), KEYPOINT={"NUM_PTS": 20})
    elif case == "train_sample":
        d = h36m_dict(TRAIN_SAMPLE=2)
    elif case == "rpsm":
        d = merged(d, KEYPOINT={"TRIANGULATION": "rpsm"})
    else:
        d = merged(d, EPIPOLAR={"TOPK": int(case[-1])})
    port, ref = pair(fake_root, d, train=True)
    assert len(port) == len(ref) == (2 if case == "train_sample" else 3)
    for i in range(len(ref)):
        assert_items_equal(port[i], ref[i])


@pytest.mark.parametrize("case", ["mapping", "test_sample", "num_cam", "real3d", "rpsm"])
def test_test_options_equal_jax(fake_root, case):
    d = {"mapping": merged(h36m_dict(MAPPING=True), KEYPOINT={"NUM_PTS": 20}),
         "test_sample": h36m_dict(TEST_SAMPLE=5),
         "num_cam": merged(h36m_dict(), KEYPOINT={"NUM_CAM": 2}),
         "real3d": h36m_dict(REAL3D=True),
         "rpsm": merged(h36m_dict(), KEYPOINT={"TRIANGULATION": "rpsm"})}[case]
    port, ref = pair(fake_root, d, train=False)
    assert len(port) == len(ref)
    assert_items_equal(port[1], ref[1])


@pytest.mark.parametrize("filter_damage", [True, False])
def test_filter_damage(fake_root, filter_damage):
    port, ref = pair(fake_root, h36m_dict(FILTER_DAMAGE=filter_damage), train=False)
    assert port.grouping == ref.grouping
    assert len(port) == (11 if filter_damage else 12)
    assert port.isdamaged({"subject": 9, "action": 13, "subaction": 1})
    assert not port.isdamaged({"subject": 1, "action": 13, "subaction": 1})


@pytest.mark.parametrize("mapping", [False, True])
def test_evaluate_jdr(fake_root, mapping):
    d = merged(h36m_dict(MAPPING=mapping), KEYPOINT={"NUM_PTS": 20 if mapping else 17})
    port, ref = pair(fake_root, d, train=False)
    gt = np.array([port.db[i]["joints_2d"] for g in port.grouping for i in g])
    pred = gt + np.random.RandomState(6).randn(*gt.shape) * 4.0
    got, want = port.evaluate(pred), ref.evaluate(pred)
    assert got[1] == want[1] and 0 < got[1] < 1
    assert got[0] == want[0]


def test_train_loader_equals_jax(fake_root):
    """No workers: the shuffled order and the draws are the JAX loader's."""
    port, ref = pair(fake_root, h36m_dict("zip"), train=True, seed=0)
    got = list(pipeline.TrainLoader(port, batch_size=1, seed=0))
    want = list(jax_pipeline.DataLoader(ref, batch_size=1, shuffle=True, seed=0, drop_last=True,
                                        prefetch=0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_items_equal(g, w)


def test_eval_loader_with_workers_equals_jax(fake_root):
    """Test items draw nothing: 0 or 2 workers give the JAX batches, in
    order."""
    port, ref = pair(fake_root, h36m_dict("zip", TEST_SAMPLE=4), train=False)
    want = list(jax_pipeline.DataLoader(ref, batch_size=2, shuffle=False, drop_last=False,
                                        prefetch=0))
    for workers in (0, 2):
        got = list(pipeline.EvalLoader(port, batch_size=2, num_workers=workers))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_items_equal(g, w)


def test_train_loader_with_workers(fake_root):
    """2 workers: the same item order as the JAX loader's, and two runs
    alike.  The workers draw other reference cameras than the JAX stream,
    so only the keys no draw changes are compared: the action, and the 3D
    points, which each view rebuilds from its own camera in f64 (so to
    1e-7 mm, as tests/test_fake_h36m.py holds them)."""
    port, ref = pair(fake_root, h36m_dict("zip"), train=True, seed=0)
    runs = [list(pipeline.TrainLoader(port, batch_size=1, seed=0, num_workers=2))
            for _ in range(2)]
    want = list(jax_pipeline.DataLoader(ref, batch_size=1, shuffle=True, seed=0, drop_last=True,
                                        prefetch=0))
    for a, b, w in zip(*runs, want):
        assert_items_equal(a, b)
        np.testing.assert_array_equal(a["action"], w["action"])
        np.testing.assert_allclose(a["points-3d"], w["points-3d"], rtol=0, atol=1e-7)


class _Failing:
    """Items 0..3; item 2 raises."""

    io_bound = True

    def reseed(self, seed):
        pass

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise KeyError(f"item {i} is broken")
        return {"x": np.full(1, i)}


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_error_stops_the_run(workers):
    loader = pipeline.EvalLoader(_Failing(), batch_size=1, num_workers=workers)
    seen = []
    with pytest.raises(KeyError, match="item 2 is broken"):
        for batch in loader:
            seen.append(int(batch["x"][0, 0]))
    assert seen == [0, 1]


def test_build_dataset_dispatch(fake_root, monkeypatch):
    from epipolar_transformers_tpu_torch.config import DatasetCatalog

    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", fake_root)
    cfg, _ = config_pair(h36m_dict())
    assert type(pipeline.build_dataset(cfg, "multiview_h36m_train")).__name__ == "MultiViewH36M"
    assert type(pipeline.build_dataset(cfg, "h36m_val")).__name__ == "H36MDataset"
    loader = pipeline.make_train_loader(cfg.replace(DATASETS=cfg.DATASETS.replace(
        TRAIN=("multiview_h36m_train", "h36m_train"))))
    assert isinstance(loader.dataset, pipeline.ConcatDataset) and len(loader.dataset) == 6
    assert loader.num_workers == min(cfg.DATALOADER.NUM_WORKERS, 4 * os.cpu_count())
    monkeypatch.setitem(DatasetCatalog.DATASETS, "odd", {"factory": "Odd", "is_train": True})
    with pytest.raises(NotImplementedError, match="no 'Odd' factory"):
        pipeline.build_dataset(cfg, "odd")


@pytest.mark.parametrize("size,batch,iters,shuffle", [(10, 3, 7, True), (8, 4, 5, False),
                                                      (5, 5, 3, True)])
def test_iteration_sampler(size, batch, iters, shuffle):
    got = list(IterationBasedBatchSampler(size, batch, iters, shuffle=shuffle, seed=3))
    want = list(jax_samplers.IterationBasedBatchSampler(size, batch, iters, shuffle=shuffle,
                                                        seed=3))
    assert got == want and len(got) == iters
    with pytest.raises(ValueError):
        IterationBasedBatchSampler(2, 3, 1)


@pytest.fixture(scope="module")
def mpii_root(tmp_path_factory):
    """tests/test_remaining_paths.py's MPII fixture: 4 random 1002x1000
    JPEGs and their annotations."""
    root = tmp_path_factory.mktemp("mpii")
    rng = np.random.RandomState(0)
    os.makedirs(root / "mpii" / "images")
    os.makedirs(root / "mpii" / "annot")
    anno = []
    for i in range(4):
        name = f"{i:05d}.jpg"
        cv2.imwrite(str(root / "mpii" / "images" / name),
                    (rng.rand(1002, 1000, 3) * 255).astype(np.uint8))
        anno.append({"image": name, "center": [500.0, 480.0], "scale": 3.0,
                     "joints": (rng.rand(16, 2) * 800 + 100).tolist(), "joints_vis": [1] * 16})
    with open(root / "mpii" / "annot" / "train.json", "w") as f:
        json.dump(anno, f)
    return str(root)


MPII_DICT = {
    "DATASETS": {"TASK": "keypoint", "IMAGE_SIZE": (64, 64), "DATA_FORMAT": "jpg"},
    "BACKBONE": {"DOWNSAMPLE": 4},
    "KEYPOINT": {"NUM_PTS": 20, "HEATMAP_SIZE": (16, 16), "SIGMA": 2.0},
}


@pytest.mark.parametrize("train", [False, True])
def test_mpii_items_equal_jax(mpii_root, train):
    cfg, jcfg = config_pair(MPII_DICT)
    port = mpii.MPIIDataset(cfg, mpii_root, "train", is_train=train, seed=SEED)
    ref = jax_mpii.MPIIDataset(jcfg, mpii_root, "train", is_train=train)
    np.random.seed(SEED)
    assert len(port) == len(ref) == 4
    for i in (0, 3):
        assert_items_equal(port[i], ref[i])


def test_multiview_mpii_and_mixed_equal_jax(fake_root, mpii_root, tmp_path):
    """MixedDataset: the H36M groups, then the MPII quadruples (one tree
    holding both)."""
    root = str(tmp_path)
    for sub in ("h36m", "mpii"):
        os.symlink(os.path.join(fake_root if sub == "h36m" else mpii_root, sub),
                   os.path.join(root, sub))
    d = merged(h36m_dict(), KEYPOINT={"NUM_PTS": 17})
    cfg, jcfg = config_pair(d)
    port = mpii.MixedDataset(
        multiview_h36m.MultiViewH36M(cfg, root, anno(root, False), is_train=False),
        mpii.MultiviewMPIIDataset(cfg, root, "train", is_train=False))
    ref = jax_mpii.MixedDataset(
        jax_h36m.MultiViewH36M(jcfg, root, anno(root, False), is_train=False),
        jax_mpii.MultiviewMPIIDataset(jcfg, root, "train", is_train=False))
    assert len(port) == len(ref) == 12
    assert port.io_bound and ref.io_bound
    for i in (0, 11):
        assert_items_equal(port[i], ref[i])


def test_card_writer_matches_make_split(fake_root, tmp_path):
    """chip_smoke.write_fake_h36m: annotation pickles equal make_split's
    records bit for bit; its frames (the port's encoder) decode within
    FRAME_PSNR_DB of make_split's (cv2's), and its undistorted members
    within UNDISTORTED_PSNR_DB."""
    from chip_smoke import write_fake_h36m

    from epipolar_transformers_tpu_torch.utils import zipreader

    root = str(tmp_path)
    write_fake_h36m(root, train_groups=3, val_groups=12, image_size=200)
    for name in ("h36m_train.pkl", "h36m_validation.pkl"):
        with open(os.path.join(fake_root, "h36m", "annot", name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(root, "h36m", "annot", name), "rb") as f:
            got = pickle.load(f)
        assert pickle.dumps(got) == pickle.dumps(want)
    with open(anno(root, True), "rb") as f:
        records = pickle.load(f)
    for rec in records[:4]:
        for where, floor in (("", FRAME_PSNR_DB), ("images.zip@", FRAME_PSNR_DB),
                             ("undistoredimages.zip@", UNDISTORTED_PSNR_DB)):
            paths = [os.path.join(r, "h36m", where, "images", rec["image"])
                     for r in (root, fake_root)]
            ours, theirs = (zipreader.imread(p) if where else cv2.imread(p) for p in paths)
            assert ours.shape == theirs.shape
            mse = np.mean((ours.astype(np.float64) - theirs) ** 2)
            assert 10 * np.log10(255.0 ** 2 / mse) > floor


# the two encoders differ (chroma rounding, DCT arithmetic); the frames are
# smooth, so the two files decode close, and a second encode after the
# undistortion adds its own rounding
FRAME_PSNR_DB = 40.0
UNDISTORTED_PSNR_DB = 38.0


class _FailingEarly(_Failing):
    """Items 0..7; item 4 raises, and worker 0 (items 0, 2, 4, 6) stops
    there, so item 6 of the same batch never comes."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 4:
            raise KeyError(f"item {i} is broken")
        return {"x": np.full(1, i)}


def test_worker_error_inside_a_batch_stops_the_run():
    loader = pipeline.EvalLoader(_FailingEarly(), batch_size=4, num_workers=2)
    with pytest.raises(KeyError, match="item 4 is broken"):
        for _ in loader:
            pass


class _Items(_Failing):
    """Items 0..3, none broken."""

    def __getitem__(self, i):
        return {"x": np.full(1, i)}


def test_stop_workers_leaves_no_process():
    """After a loader on forkserver workers, `stop_workers` ends the server
    and the resource tracker and waits for both, so neither outlives the
    program; a later loader starts them anew."""
    from multiprocessing import forkserver, resource_tracker

    for _ in range(2):
        loader = pipeline.EvalLoader(_Items(), batch_size=1, num_workers=2,
                                     start_method="forkserver")
        assert [int(b["x"][0, 0]) for b in loader] == [0, 1, 2, 3]
        pids = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
        assert all(pids)
        pipeline.stop_workers()
        assert not [pid for pid in pids if os.path.exists(f"/proc/{pid}")]
