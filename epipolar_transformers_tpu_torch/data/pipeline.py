"""Host batching for the port.

`collate` is the JAX package's (epipolar_transformers_tpu/data/pipeline.py,
numpy only, imported rather than copied).  `eval_batches` yields the
(1, V, ...) view groups the eval loop takes, one dataset item each.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from epipolar_transformers_tpu.data.pipeline import collate

__all__ = ["collate", "eval_batches"]


def eval_batches(dataset) -> Iterator[Dict[str, np.ndarray]]:
    """One collated (1, V, ...) view group per item of `dataset`."""
    for i in range(len(dataset)):
        yield collate([dataset[i]])
