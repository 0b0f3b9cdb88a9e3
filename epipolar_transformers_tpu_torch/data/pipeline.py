"""Host batching for the port.

`collate`, `ConcatDataset` and the batching `DataLoader` are the JAX
package's (epipolar_transformers_tpu/data/pipeline.py, numpy only, imported
rather than copied).  `eval_batches` yields the (1, V, ...) view groups the
eval loop takes, one dataset item each; `make_train_loader` is the train
half of the JAX `make_data_loader`.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from epipolar_transformers_tpu.config import Config
from epipolar_transformers_tpu.config.catalog import DatasetCatalog
from epipolar_transformers_tpu.data.pipeline import ConcatDataset, DataLoader, collate

__all__ = ["build_dataset", "collate", "eval_batches", "make_train_loader"]


def eval_batches(dataset) -> Iterator[Dict[str, np.ndarray]]:
    """One collated (1, V, ...) view group per item of `dataset`."""
    for i in range(len(dataset)):
        yield collate([dataset[i]])


def build_dataset(cfg: Config, name: str):
    """A DatasetCatalog name -> the port's dataset.  The port has the
    synthetic rig; the real-image datasets are ROADMAP A9/A11."""
    entry = DatasetCatalog.get(name)
    if entry["factory"] != "SyntheticMultiview":
        raise NotImplementedError(
            f"dataset {name!r} ({entry['factory']}): the port has SyntheticMultiview; "
            "the real-image datasets are ROADMAP A9/A11")
    from .datasets.synthetic import SyntheticMultiview

    return SyntheticMultiview(cfg, is_train=entry["is_train"],
                              n_samples=entry.get("n_samples", 256),
                              seed=entry.get("seed", 0))


def make_train_loader(cfg: Config) -> DataLoader:
    """DATASETS.TRAIN concatenated into one shuffled loader of
    SOLVER.IMS_PER_BATCH items that drops the last partial batch (JAX
    `make_data_loader(cfg, is_train=True)`).  Each batch is a fresh host
    buffer (no ring reuse), so a batch may be copied to the device
    asynchronously and kept as long as the caller likes."""
    datasets = [build_dataset(cfg, n) for n in cfg.DATASETS.TRAIN]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    return DataLoader(dataset, batch_size=cfg.SOLVER.IMS_PER_BATCH, shuffle=True,
                      seed=cfg.SEED, drop_last=True, reuse_buffers=False)
