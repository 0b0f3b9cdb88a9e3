"""Config pairs for the port's parity tests.

The port keeps its own copy of the config tree, so each parity test builds
the port's config with the port's package and the JAX side's with the JAX
package, from the same dict; tests/test_torch_config.py holds the two trees
equal.
"""

from __graft_entry__ import _flagship_cfg
from epipolar_transformers_tpu.config import Config as JConfig
from epipolar_transformers_tpu.config import update_from_dict as jax_update
from epipolar_transformers_tpu_torch.config import Config, flagship_cfg, update_from_dict


def config_pair(d=None, tiny_flagship: bool = False):
    """(port config, JAX config): the default tree, or the tiny flagship,
    each updated from `d`."""
    d = d or {}
    if tiny_flagship:
        return update_from_dict(flagship_cfg(tiny=True), d), jax_update(_flagship_cfg(tiny=True), d)
    return update_from_dict(Config(), d), jax_update(JConfig(), d)
