"""Import a foreign torch state dict (a reference checkpoint) into the port.

The port's own copies of `load_torch_state_dict`, `strip_prefix`,
`convert_state_dict` and `align_by_suffix` from
epipolar_transformers_tpu/utils/torch_import.py (tests/test_torch_pretrained.py
holds the import equal to the JAX package's, leaf for leaf).

The JAX import aligns in flax-path space, and so does `load_into_model`:
the file's torch keys go through `torch_key_to_flax_path` and the flax
leaf conversion (`convert_state_dict`); the model's own keys go through
`utils/jax_import.py:flax_paths`, which inserts the `norm` level of the
zero-init BN under `epipolar_sampler/bn`, the classifier's `trunk` and the
lifting net's flax names.  Matching torch keys against torch
keys directly would differ: the nested `norm` breaks the JAX suffix match,
so a file's `epipolar_sampler.bn.*` leaves the JAX model at its initial
values, and must leave the port there too.
"""

from __future__ import annotations

import logging
import pickle
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from .jax_import import flax_paths, to_port_value
from .torch_keys import torch_key_to_flax_path

logger = logging.getLogger(__name__)


def read_torch_file(path: str):
    """The unpickled payload of a torch file, through the weights-only
    unpickler where it suffices (the port's own checkpoints, plain state
    dicts).  A reference checkpoint may hold more than tensors, and only
    such a file falls back to the full unpickler: read only files you
    trust, as with the JAX package's import."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        logger.info("%s needs the full unpickler (it holds more than tensors)", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path_or_payload) -> Dict[str, np.ndarray]:
    """A torch checkpoint (a path, or a payload already read) as {key:
    numpy array}: unwraps the reference's {'model': state_dict} and calls
    `.state_dict()` on a module (reference checkpoint.py:28-46)."""
    payload = (read_torch_file(path_or_payload) if isinstance(path_or_payload, str)
               else path_or_payload)
    if isinstance(payload, dict) and "model" in payload:
        payload = payload["model"]
    if hasattr(payload, "state_dict"):
        payload = payload.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in payload.items() if hasattr(v, "detach")}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str = "", prefix_replace: str = "",
                 allow_diff_prefix: bool = False) -> Dict[str, np.ndarray]:
    """reference model_serialization.py:59-76.  An empty prefix with a
    replacement prepends the replacement to every key.  When not every key
    carries `prefix`: with `allow_diff_prefix` (WEIGHTS_ALLOW_DIFF_PREFIX)
    the keys without it are dropped and the others stripped; without it the
    dict is returned untouched."""
    if not prefix:
        if prefix_replace:
            return {prefix_replace + k: v for k, v in sd.items()}
        return dict(sd)
    if not all(k.startswith(prefix) for k in sd):
        warnings.warn(f"Not all keys contain the prefix {prefix!r}")
        if not allow_diff_prefix:
            return dict(sd)
        return {prefix_replace + k[len(prefix):]: v
                for k, v in sd.items() if k.startswith(prefix)}
    return {prefix_replace + k[len(prefix):]: v for k, v in sd.items()}


def _is_deconv(path) -> bool:
    return any(p.startswith("deconv") and "layers" not in p for p in path)


def _to_flax_layout(value: np.ndarray, leaf: str, is_deconv: bool) -> Tuple[str, np.ndarray]:
    """One torch tensor as the flax leaf (name, array): conv OIHW -> HWIO,
    deconv (I, O, kh, kw) -> (kh, kw, I, O) spatially flipped, Linear
    (O, I) -> (I, O), BN weight/running stats -> scale/mean/var."""
    if leaf == "weight":
        if value.ndim == 4:
            if is_deconv:
                return "kernel", np.ascontiguousarray(
                    np.transpose(value, (2, 3, 0, 1))[::-1, ::-1])
            return "kernel", np.transpose(value, (2, 3, 1, 0))
        if value.ndim == 2:
            return "kernel", value.T
        return "scale", value
    return {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf), value


def convert_state_dict(torch_sd: Dict[str, np.ndarray], prefix: str = "",
                       prefix_replace: str = "", allow_diff_prefix: bool = False):
    """Torch state dict -> ({params path: array}, {batch_stats path: array}),
    '/'-joined flax paths, arrays in the flax layout."""
    sd = strip_prefix(torch_sd, prefix, prefix_replace, allow_diff_prefix)
    params, stats = {}, {}
    for key, value in sd.items():
        path, leaf, kind = torch_key_to_flax_path(key)
        if kind == "skip":
            continue
        name, arr = _to_flax_layout(np.asarray(value), leaf, _is_deconv(path))
        (stats if kind == "bn_stat" else params)["/".join(path + (name,))] = arr
    return params, stats


def align_by_suffix(flax_flat: Dict[tuple, np.ndarray], source: Dict[str, np.ndarray]):
    """Suffix-matching alignment (reference model_serialization.py:9-57):
    each destination leaf takes the source key with the longest matching
    '/'-suffix, where one key is a full suffix of the other, and the same
    shape.  Returns ({path: array}, the '/'-joined paths that kept their
    value)."""
    matched, missing = {}, []
    for path, current in flax_flat.items():
        best_key, best_n = None, 0
        for skey, arr in source.items():
            segs = tuple(skey.split("/"))
            n = 0
            while n < min(len(segs), len(path)) and segs[-1 - n] == path[-1 - n]:
                n += 1
            if n < min(len(segs), len(path)):
                continue
            if tuple(arr.shape) != tuple(np.shape(current)):
                continue
            if n > best_n:
                best_key, best_n = skey, n
        if best_key is not None:
            matched[path] = np.asarray(source[best_key], dtype=np.asarray(current).dtype)
        else:
            matched[path] = current
            missing.append("/".join(path))
    if missing:
        logger.info("torch import: %d leaves kept their init (e.g. %s)", len(missing), missing[:5])
    return matched, missing


def import_flax_leaves(model: torch.nn.Module, params_src: Dict[str, np.ndarray],
                       stats_src: Dict[str, np.ndarray]) -> List[str]:
    """Align '/'-joined flax-path leaves (flax layout) into `model` in place,
    by suffix in flax-path space as the JAX package does, each matched leaf
    converted to the port's layout; returns the parameter leaves that kept
    their value."""
    state = model.state_dict()
    where = {}  # collection -> {flax path: (port key, is_deconv, fc0 channels)}
    flat = {"params": {}, "batch_stats": {}}
    for key, (coll, path, is_deconv, fc0) in flax_paths(model).items():
        _, leaf = key.rsplit(".", 1)
        flat[coll][path] = _to_flax_layout(state[key].detach().cpu().numpy(), leaf, is_deconv)[1]
        where.setdefault(coll, {})[path] = (key, is_deconv, fc0)
    new_params, missing = align_by_suffix(flat["params"], params_src)
    new_stats = align_by_suffix(flat["batch_stats"], stats_src)[0] if stats_src else {}
    new_state = dict(state)
    kept = set(missing)
    for coll, new in (("params", new_params), ("batch_stats", new_stats)):
        for path, arr in new.items():
            key, is_deconv, fc0 = where[coll][path]
            if coll == "params" and "/".join(path) in kept:
                continue
            value = to_port_value(np.asarray(arr), path, is_deconv, fc0)
            new_state[key] = torch.from_numpy(np.array(value)).to(state[key].dtype)
    model.load_state_dict(new_state, strict=True)
    return missing


def load_into_model(model: torch.nn.Module, torch_sd: Dict[str, np.ndarray], prefix: str = "",
                    prefix_replace: str = "", submodule: str = "",
                    allow_diff_prefix: bool = False) -> List[str]:
    """Import `torch_sd` into `model` in place, as the JAX package's
    `load_into_variables` imports it into flax variables; `submodule` (e.g.
    'reference') is the path the file's keys land under.  Every value is
    copied.  Returns the parameter leaves that kept their value."""
    params_src, stats_src = convert_state_dict(torch_sd, prefix, prefix_replace,
                                               allow_diff_prefix)
    if submodule:
        params_src = {f"{submodule}/{k}": v for k, v in params_src.items()}
        stats_src = {f"{submodule}/{k}": v for k, v in stats_src.items()}
    return import_flax_leaves(model, params_src, stats_src)
