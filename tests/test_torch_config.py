"""The port's own copies of what it once took from the JAX package stay equal
to the originals: the config tree and its YAML loading, the catalogs, the
torch-key -> flax-path map, and the train loader's order.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from epipolar_transformers_tpu import config as jconfig
from epipolar_transformers_tpu.data.pipeline import DataLoader as JDataLoader
from epipolar_transformers_tpu.utils.torch_import import torch_key_to_flax_path as jax_key_map
from epipolar_transformers_tpu_torch import config
from epipolar_transformers_tpu_torch.data.pipeline import TrainLoader
from epipolar_transformers_tpu_torch.models import ModelBuilder
from epipolar_transformers_tpu_torch.utils.torch_keys import torch_key_to_flax_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def test_default_config_trees_are_equal():
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(jconfig.Config())
    assert config.Config().EPIPOLAR.SOFTMAXSCALE == jconfig.Config().EPIPOLAR.SOFTMAXSCALE


@pytest.mark.parametrize("path", YAMLS, ids=[os.path.relpath(p, REPO) for p in YAMLS])
def test_yaml_configs_load_equal(path):
    overrides = ["SOLVER.BASE_LR", "0.01", "EPIPOLAR.SAMPLESIZE", "32"]
    got = config.load_config(path, overrides)
    want = jconfig.load_config(path, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.DATASET_FAMILY == want.DATASET_FAMILY


def test_update_from_dict_rejects_what_the_jax_package_rejects():
    for bad, error in (({"NO_SUCH_KEY": 1}, KeyError), ({"SOLVER": 3}, TypeError)):
        with pytest.raises(error):
            config.update_from_dict(config.Config(), bad)
        with pytest.raises(error):
            jconfig.update_from_dict(jconfig.Config(), bad)


def test_catalogs_agree_on_the_synthetic_entries():
    def synthetic(catalog):
        return {name: catalog.get(name) for name, entry in catalog.DATASETS.items()
                if entry["factory"] == "SyntheticMultiview"}

    ours = synthetic(config.DatasetCatalog)
    assert ours and ours == synthetic(jconfig.DatasetCatalog)
    assert config.DatasetCatalog.ALIASES == jconfig.DatasetCatalog.ALIASES
    for body in ("epipolarposeR-18", "epipolarposeR-50", "epipolarposeR-152", "HG"):
        assert config.BackboneCatalog.get(body) == jconfig.BackboneCatalog.get(body)


def test_torch_key_map_is_the_jax_packages():
    keys = ModelBuilder(config.flagship_cfg(tiny=True)).state_dict().keys()
    assert len(keys) > 100
    for key in keys:
        assert torch_key_to_flax_path(key) == jax_key_map(key), key


@pytest.mark.parametrize("body", ["epipolarHG", "metaHG"])
def test_torch_key_map_is_the_jax_packages_on_the_hourglass(body):
    cfg = config.update_from_dict(config.flagship_cfg(tiny=True), {
        "BACKBONE": {"BODY": body}, "KEYPOINT": {"NFEATS": 32},
        "EPIPOLAR": {"SHARE_WEIGHTS": False}})
    keys = ModelBuilder(cfg).state_dict().keys()
    assert len(keys) > 500 and any(".meta0.fc1." in k for k in keys) == (body == "metaHG")
    for key in keys:
        assert torch_key_to_flax_path(key) == jax_key_map(key), key


class _Indices:
    """Items that are their own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("seed,n,batch", [(0, 16, 8), (7, 37, 8), (3, 50, 4)])
def test_train_loader_order_is_the_jax_loaders(seed, n, batch):
    """Two epochs, shuffled with the same seed, the last partial batch
    dropped; an epoch left early does not advance the order."""
    ours = TrainLoader(_Indices(n), batch_size=batch, seed=seed)
    ref = JDataLoader(_Indices(n), batch_size=batch, shuffle=True, seed=seed, drop_last=True,
                      prefetch=0)
    assert len(ours) == len(ref) == n // batch
    for _ in range(2):
        got = [b["i"].tolist() for b in ours]
        want = [b["i"].tolist() for b in ref]
        assert got == want
    first = next(iter(ours))["i"].tolist()
    assert first == next(iter(ours))["i"].tolist() == [b["i"].tolist() for b in ref][0]
    assert torch.tensor(sum(got, [])).unique().numel() == len(ours) * batch
