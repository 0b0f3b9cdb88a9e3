"""Iteration-based batch sampling.

The port's own copy of epipolar_transformers_tpu/data/samplers.py
(reference data/samplers/iteration_based_batch_sampler.py:4-30): an
epoch-free stream of index batches for step-budgeted training, reshuffled
with `np.random.RandomState(seed + epoch)` at each epoch boundary, the same
stream as the JAX class's (tests/test_torch_h36m.py holds them equal).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class IterationBasedBatchSampler:
    """Yields batches of dataset indices until `num_iterations` is reached,
    reshuffling each epoch; the last partial batch of an epoch is dropped."""

    def __init__(self, dataset_size: int, batch_size: int, num_iterations: int,
                 shuffle: bool = True, seed: int = 0, start_iter: int = 0):
        if dataset_size < batch_size:
            raise ValueError(f"dataset_size ({dataset_size}) < batch_size ({batch_size}): "
                             "no full batch can ever be formed")
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.num_iterations = num_iterations
        self.shuffle = shuffle
        self.seed = seed
        self.start_iter = start_iter

    def __len__(self) -> int:
        return self.num_iterations - self.start_iter

    def __iter__(self) -> Iterator[List[int]]:
        iteration, epoch = self.start_iter, 0
        while iteration < self.num_iterations:
            idx = np.arange(self.dataset_size)
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            for b in range(0, self.dataset_size - self.batch_size + 1, self.batch_size):
                if iteration >= self.num_iterations:
                    return
                yield idx[b:b + self.batch_size].tolist()
                iteration += 1
            epoch += 1
