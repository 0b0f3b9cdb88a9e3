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

Traps:
  * flax's ZeroInitBatchNorm nests its BatchNorm one level deeper
    (`epipolar_sampler/bn/norm/...` and `epipolar_sampler1/bn/norm/...`,
    models/layers.py of the JAX package) and the name map does not insert
    `norm`; `_flax_path` does;
  * the classifier ResNet nests its trunk under `trunk` in flax, and the
    port keeps the reference's top-level names; `flax_paths` inserts it;
  * LiftingNet's Sequentials carry the reference's indices: conv{1,2}.{2i}
    and .{2i+1} are flax's conv{1,2}_conv{i}, poseprior/viewpoint .0, .3,
    .6 its fc0, fc1 and out.  The first dense layer of each conv head
    (`fc0`) reads the features flattened NHWC in JAX and NCHW in the port,
    so its input rows are permuted (`nhwc_to_nchw_columns`), the hand-side
    columns staying at the end.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Set, Tuple

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


_LIFT_CONV = re.compile(r"(conv[12])\.(\d+)")
_LIFT_FC = {"0": "fc0", "3": "fc1", "6": "out"}
_FC0_CHANNELS = {"poseprior": 128, "viewpoint": 256}  # the conv stacks' last widths


def _lifting_path(rel: str, ndim: int):
    """A LiftingNet-relative port key -> (flax path, fc0 channels or None)."""
    mods, leaf = rel.rsplit(".", 1)
    name = "kernel" if leaf == "weight" else leaf
    m = _LIFT_CONV.fullmatch(mods)
    if m:
        return (f"{m.group(1)}_conv{int(m.group(2)) // 2}", name), None
    head, _, idx = mods.partition(".")
    if not idx:  # a single Dense on image features
        return (head, name), None
    fc0 = _FC0_CHANNELS[head] if idx == "0" and leaf == "weight" else None
    return (head, _LIFT_FC[idx], name), fc0


def flax_paths(module: torch.nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...], bool,
                                                           Optional[int]]]:
    """Each port state-dict key of `module` -> (collection, flax path,
    is_deconv, fc0 channels: the conv width whose NHWC rows a lifting head's
    fc0 permutes, else None)."""
    from ..models.lifting import LiftingNet
    from ..models.resnet import ResNet

    special = [(name + "." if name else "", type(m)) for name, m in module.named_modules()
               if isinstance(m, (LiftingNet, ResNet))]
    out = {}
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        for prefix, kind in special:
            if key.startswith(prefix):
                base = tuple(p for p in prefix.split(".") if p)
                if kind is LiftingNet:
                    path, fc0 = _lifting_path(key[len(prefix):], value.ndim)
                    out[key] = ("params", base + path, False, fc0)
                else:
                    coll, path, is_deconv = _flax_path(key, value.ndim)
                    out[key] = (coll, base + ("trunk",) + path[len(base):], is_deconv, None)
                break
        else:
            out[key] = _flax_path(key, value.ndim) + (None,)
    return out


def nhwc_to_nchw_columns(w: np.ndarray, channels: int) -> np.ndarray:
    """(O, I) dense weight whose first I - side columns index NHWC-flattened
    features ([hw, c]) -> NCHW ([c, hw]); the trailing side columns (the
    hand-side one-hot, I mod channels of them) stay at the end."""
    O, I = w.shape
    hw = I // channels
    conv = w[:, :hw * channels].reshape(O, hw, channels).transpose(0, 2, 1)
    return np.concatenate([conv.reshape(O, hw * channels), w[:, hw * channels:]], axis=1)


def nchw_to_nhwc_columns(w: np.ndarray, channels: int) -> np.ndarray:
    """The inverse of `nhwc_to_nchw_columns`."""
    O, I = w.shape
    hw = I // channels
    conv = w[:, :hw * channels].reshape(O, channels, hw).transpose(0, 2, 1)
    return np.concatenate([conv.reshape(O, hw * channels), w[:, hw * channels:]], axis=1)


def to_port_value(value: np.ndarray, path: Tuple[str, ...], is_deconv: bool,
                  fc0: Optional[int]) -> np.ndarray:
    """A flax leaf in the port's layout (`_to_torch_layout`, then the fc0
    column permutation)."""
    value = _to_torch_layout(np.asarray(value), path[-1], is_deconv)
    return value if fc0 is None else nhwc_to_nchw_columns(value, fc0)


def _to_torch_layout(value: np.ndarray, leaf_name: str, is_deconv: bool) -> np.ndarray:
    if leaf_name == "kernel" and value.ndim == 4:
        if is_deconv:
            # flax (kh, kw, I, O), spatially flipped -> torch (I, O, kh, kw)
            return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf_name == "kernel" and value.ndim == 2:
        return value.T  # nn.Dense (I, O) -> nn.Linear (O, I)
    return value


def _to_flax_value(value: np.ndarray, path: Tuple[str, ...], is_deconv: bool,
                   fc0: Optional[int]) -> np.ndarray:
    """The inverse of `to_port_value`: a port tensor in the flax layout."""
    if fc0 is not None:
        value = nchw_to_nhwc_columns(value, fc0)
    if path[-1] == "kernel" and value.ndim == 4:
        if is_deconv:
            return np.ascontiguousarray(np.transpose(value, (2, 3, 0, 1))[::-1, ::-1])
        return np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))
    if path[-1] == "kernel" and value.ndim == 2:
        return np.ascontiguousarray(value.T)
    return value


def flax_variables(module: torch.nn.Module) -> Dict[str, dict]:
    """`module`'s weights as the JAX package's variables tree
    ({'params': ..., 'batch_stats': ...}, nested dicts of numpy arrays in
    the flax layout): the inverse of `jax_state_dict`."""
    state = module.state_dict()
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, (coll, path, is_deconv, fc0) in flax_paths(module).items():
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        value = state[key].detach().cpu()
        value = value.float() if value.dtype == torch.bfloat16 else value
        node[path[-1]] = _to_flax_value(value.numpy(), path, is_deconv, fc0)
    return out


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
    paths = flax_paths(module)
    new_state: Dict[str, torch.Tensor] = {}
    used = set()
    for key, current in state.items():
        if key not in paths:
            new_state[key] = current
            continue
        coll, path, is_deconv, fc0 = paths[key]
        try:
            value = np.asarray(_lookup(variables[coll], path))
        except KeyError:
            raise KeyError(f"no JAX leaf {coll}/{'/'.join(path)} for port key {key}") from None
        value = to_port_value(value, path, is_deconv, fc0)
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

