"""Static attention configuration shared by the attention implementations.

Port of `AttentionParams` and `NEG_INF` from epipolar_transformers_tpu/ops/
epipolar_attention.py.  The two-pass oracle of that module comes with the
other attention configurations (ROADMAP A10).
"""

from __future__ import annotations

from typing import NamedTuple

NEG_INF = -1e10  # reference epipolar.py:298


class AttentionParams(NamedTuple):
    """Static attention configuration (subset of EPIPOLAR.*)."""

    attention: str = "avg"  # 'avg' | 'max'
    similarity: str = "dot"  # 'dot' | 'cos' | 'prior'
    softmax_enabled: bool = True
    softmax_scale: float = 0.125  # 1/sqrt(K)
    pooling: bool = False
    priormul: bool = False
    correct_normalize: bool = True
