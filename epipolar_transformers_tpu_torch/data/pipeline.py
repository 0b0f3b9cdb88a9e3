"""Host batching for the port.

`collate` stacks items as the JAX package's does
(epipolar_transformers_tpu/data/pipeline.py).  `make_train_loader` and
`make_eval_loaders` are the two halves of the JAX `make_data_loader`: a
synchronous `TrainLoader` that gives the JAX `DataLoader`'s shuffled order
for the same seed (tests/test_torch_config.py holds the two equal), and one
`EvalLoader` per DATASETS.TEST in order, whose batches of TEST.IMS_PER_BATCH
(B, V, ...) view groups the eval engine takes.  The JAX loader's worker
processes, prefetch thread and ring buffers are not needed here: each batch
is a fresh host buffer, so it may be copied to the device asynchronously and
kept as long as the caller likes.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
from torch.utils.data import ConcatDataset

from ..config import Config, DatasetCatalog

__all__ = ["EvalLoader", "TrainLoader", "build_dataset", "collate", "make_eval_loaders",
           "make_train_loader"]


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack a list of per-item dicts into batched arrays."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class EvalLoader:
    """`dataset` in order, in batches of `batch_size` items; the last
    partial batch is kept (the JAX `DataLoader(shuffle=False,
    drop_last=False)`)."""

    def __init__(self, dataset, batch_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            yield collate([self.dataset[i] for i in range(start, min(start + self.batch_size, n))])


class TrainLoader:
    """Shuffled batches of `batch_size` items; the last partial batch is
    dropped.  Epoch e visits the items in the order
    `np.random.RandomState(seed + e).shuffle(np.arange(n))`, as the JAX
    `DataLoader(shuffle=True, drop_last=True)` does; the epoch counts only
    passes that ran to their end, as there."""

    def __init__(self, dataset, batch_size: int, seed: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def indices(self) -> np.ndarray:
        """This epoch's item order."""
        idx = np.arange(len(self.dataset))
        np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self.indices()
        for b in range(len(self)):
            batch = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in batch])
        self.epoch += 1


def build_dataset(cfg: Config, name: str):
    """A DatasetCatalog name (or alias, 'RHD_train'/'RHD_val') -> the port's
    dataset: the synthetic rig or RHD.  The H36M and MPII datasets are
    ROADMAP A11a."""
    entry = DatasetCatalog.get(name)
    factory = entry["factory"]
    if factory == "SyntheticMultiview":
        from .datasets.synthetic import SyntheticMultiview

        return SyntheticMultiview(cfg, is_train=entry["is_train"],
                                  n_samples=entry.get("n_samples", 256),
                                  seed=entry.get("seed", 0))
    if factory == "RHDDataset":
        from .datasets.rhd import RHDDataset

        return RHDDataset(cfg, entry["root"], entry["set"], is_train=entry["is_train"],
                          seed=cfg.SEED)
    raise NotImplementedError(
        f"dataset {name!r} ({factory}): the port has SyntheticMultiview and RHDDataset; "
        "the H36M and MPII datasets are ROADMAP A11a")


def make_train_loader(cfg: Config) -> TrainLoader:
    """DATASETS.TRAIN concatenated into one shuffled loader of
    SOLVER.IMS_PER_BATCH items that drops the last partial batch (JAX
    `make_data_loader(cfg, is_train=True)`)."""
    datasets = [build_dataset(cfg, n) for n in cfg.DATASETS.TRAIN]
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)
    return TrainLoader(dataset, batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=cfg.SEED)


def make_eval_loaders(cfg: Config) -> List[EvalLoader]:
    """One loader per DATASETS.TEST, in batches of TEST.IMS_PER_BATCH (JAX
    `make_data_loader(cfg, is_train=False)`)."""
    return [EvalLoader(build_dataset(cfg, n), cfg.TEST.IMS_PER_BATCH) for n in cfg.DATASETS.TEST]
