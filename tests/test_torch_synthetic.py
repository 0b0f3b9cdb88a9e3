"""The port's SyntheticMultiview items are bit-equal to the JAX package's.

The port's dataset takes its helpers (neighbour ranking, heatmap grid,
joint colours) from its own numpy modules; the items must not change by a
bit.  Train items draw the reference view and augmentation from the global
numpy RNG, so both sides are seeded identically.
"""

import numpy as np
import pytest

from epipolar_transformers_tpu.data.datasets.synthetic import SyntheticMultiview as JSynthetic
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from torch_configs import config_pair


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("is_train,augment", [(False, False), (True, False), (True, True)])
def test_items_bit_equal(is_train, augment):
    cfg, jcfg = config_pair(
        {"DATASETS": {"SCALE_FACTOR": 0.25, "ROT_FACTOR": 30.0}} if augment else {},
        tiny_flagship=True)
    ours = SyntheticMultiview(cfg, is_train=is_train, n_samples=3, seed=5)
    ref = JSynthetic(jcfg, is_train=is_train, n_samples=3, seed=5)
    for i in range(len(ref)):
        np.random.seed(100 + i)
        want = ref[i]
        np.random.seed(100 + i)
        _assert_items_equal(ours[i], want)
