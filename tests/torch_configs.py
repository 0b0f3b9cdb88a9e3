"""Config pairs for the port's parity tests.

The port keeps its own copy of the config tree, so each parity test builds
the port's config with the port's package and the JAX side's with the JAX
package, from the same dict; tests/test_torch_config.py holds the two trees
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from epipolar_transformers_tpu.config import Config as JConfig
from epipolar_transformers_tpu.config import update_from_dict as jax_update
from epipolar_transformers_tpu.ops import epipolar_sampling as jsampling
from epipolar_transformers_tpu_torch.config import Config, flagship_cfg, update_from_dict


def config_pair(d=None, tiny_flagship: bool = False):
    """(port config, JAX config): the default tree, or the tiny flagship,
    each updated from `d`."""
    d = d or {}
    if tiny_flagship:
        return update_from_dict(flagship_cfg(tiny=True), d), jax_update(_flagship_cfg(tiny=True), d)
    return update_from_dict(Config(), d), jax_update(JConfig(), d)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for a test module that imports this
    fixture: the suite runs one worker per core, and each worker's default
    of one torch thread per core oversubscribes the machine (a tiny train
    step on the CPU then reads ~6x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_sample_locs(P1, P2, geom, grid=None):
    """The JAX package's sample locations of the port's (N, 3, 4) view
    pairs, as a torch tensor on their device: a drop-in for the port's
    `epipolar_sample_locs` in the layer, so that a parity test holds the
    layer, not the two f32 geometries (which differ by up to ~5e-5 on the
    rig's lines; tests/test_torch_geometry.py holds those)."""
    assert grid is None
    g = jsampling.EpipolarGeometry(*geom)
    locs = jax.vmap(lambda a, b: jsampling.epipolar_sample_locs(a, b, g, jnp.asarray(g.grid())))(
        jnp.asarray(P1.detach().cpu().numpy(), jnp.float32),
        jnp.asarray(P2.detach().cpu().numpy(), jnp.float32))
    return torch.from_numpy(np.array(locs, np.float32)).to(P1.device)
