"""Carry a JAX model's weights into the port.

`load_jax_variables(module, variables)` takes the JAX package's
{'params', 'batch_stats'} tree (numpy arrays) and fills the port module's
state dict with strict=True; `jax_state_dict` is the same conversion
without loading, so that a JAX tree after a train step (or a tree of
gradients in place of 'params') can be compared with the port's state.  It inverts the torch -> flax import of
epipolar_transformers_tpu.utils.torch_import: each port key goes through
`torch_key_to_flax_path` (the port's copy, utils/torch_keys.py), then the
leaf conversion is undone:
  * conv kernel HWIO -> OIHW;
  * deconv kernel (kh, kw, I, O) -> (I, O, kh, kw) with the spatial flip;
  * dense kernel (I, O) -> (O, I) (the hourglass's Meta `fc0`/`fc1`);
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * the learned prior table (`epipolar_sampler/prior`, (pairs, K', H, W))
    as it is.

Trap: flax's ZeroInitBatchNorm nests its BatchNorm one level deeper
(`epipolar_sampler/bn/norm/...` and `epipolar_sampler1/bn/norm/...`,
models/layers.py of the JAX package) and the name map does not insert
`norm`; `_flax_path` does.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch

from .torch_keys import torch_key_to_flax_path

_BN_LEAF = {"weight": "scale", "bias": "bias",
            "running_mean": "mean", "running_var": "var"}


def _flax_path(key: str, ndim: int) -> Tuple[str, Tuple[str, ...], bool]:
    """Port state-dict key -> (collection, flax path, is_deconv)."""
    path, leaf, kind = torch_key_to_flax_path(key)
    if len(path) >= 2 and path[-2] in ("epipolar_sampler", "epipolar_sampler1") \
            and path[-1] == "bn":
        path = path + ("norm",)
    if kind in ("bn_param", "bn_stat"):
        coll = "batch_stats" if kind == "bn_stat" else "params"
        return coll, path + (_BN_LEAF[leaf],), False
    is_deconv = any(p.startswith("deconv") and "layers" not in p for p in path)
    name = "kernel" if (leaf == "weight" and ndim >= 2) else leaf
    return "params", path + (name,), is_deconv


def _to_torch_layout(value: np.ndarray, leaf_name: str, is_deconv: bool) -> np.ndarray:
    if leaf_name == "kernel" and value.ndim == 4:
        if is_deconv:
            # flax (kh, kw, I, O), spatially flipped -> torch (I, O, kh, kw)
            return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf_name == "kernel" and value.ndim == 2:
        return value.T  # nn.Dense (I, O) -> nn.Linear (O, I)
    return value


def _lookup(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def jax_state_dict(module: torch.nn.Module, variables
                   ) -> Tuple[Dict[str, torch.Tensor], Set[Tuple[str, ...]]]:
    """The JAX variables tree as `module`'s state dict (port key -> tensor
    in the port's layout and dtype), and the set of (collection, *path) JAX
    leaves that were used."""
    state = module.state_dict()
    new_state: Dict[str, torch.Tensor] = {}
    used = set()
    for key, current in state.items():
        if key.endswith("num_batches_tracked"):
            new_state[key] = current
            continue
        coll, path, is_deconv = _flax_path(key, current.ndim)
        try:
            value = np.asarray(_lookup(variables[coll], path))
        except KeyError:
            raise KeyError(f"no JAX leaf {coll}/{'/'.join(path)} for port key {key}") from None
        value = _to_torch_layout(value, path[-1], is_deconv)
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(f"{key}: JAX leaf shape {value.shape} != port {tuple(current.shape)}")
        new_state[key] = torch.from_numpy(np.array(value, dtype=np.float32)).to(current.dtype)
        used.add((coll,) + path)
    return new_state, used


def load_jax_variables(module: torch.nn.Module, variables) -> Set[Tuple[str, ...]]:
    """Fill `module` from the JAX variables tree; returns the set of
    (collection, *path) JAX leaves that were used."""
    new_state, used = jax_state_dict(module, variables)
    module.load_state_dict(new_state, strict=True)
    return used

