"""External (TensorFlow-pickle) weights for the lifting network.

The port's own copy of epipolar_transformers_tpu/utils/ext_model_loading.py
(reference utils/ext_model_loading.py:12-104): the hand3d project publishes
its PosePrior/ViewpointNet weights as a TF pickle
({'PosePrior/conv_pose_0_1/weights': HWCN array, ...}).  This returns them
as the JAX package does, '/'-joined flax paths in the flax layout (TF conv
kernels are HWCN, which is flax's HWIO; dense kernels stay (in, out)):
  PosePrior/conv_pose_{s}_{i}  -> conv1_conv{2s+i-1}
  ViewpointNet/conv_vp_{s}_{i} -> conv2_conv{2s+i-1}
  PosePrior/fc_rel{i}          -> poseprior/fc{i}
  PosePrior/fc_xyz             -> poseprior/out
  ViewpointNet/fc_vp{i}        -> viewpoint/fc{i}
  ViewpointNet/fc_vp_{ux,uy,uz}-> viewpoint/out (concatenated, 3 wide)
and utils/pretrained.py aligns them into the port's LiftingNet through
utils/jax_import.py, which moves them to the port's layout (TF flattens
NHWC, so the first dense rows are permuted as JAX's are).
"""

from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np


def _map_name(key: str):
    """TF variable name -> (flax path tuple, leaf) or None to skip."""
    m = re.fullmatch(r"PosePrior/conv_pose_(\d)_(\d)/(weights|biases)", key)
    if m:
        s, i, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        return ("conv1_conv%d" % (2 * s + i - 1),), leaf
    m = re.fullmatch(r"ViewpointNet/conv_vp_(\d)_(\d)/(weights|biases)", key)
    if m:
        s, i, leaf = int(m.group(1)), int(m.group(2)), m.group(3)
        return ("conv2_conv%d" % (2 * s + i - 1),), leaf
    m = re.fullmatch(r"PosePrior/fc_rel(\d)/(weights|biases)", key)
    if m:
        return ("poseprior", f"fc{m.group(1)}"), m.group(2)
    m = re.fullmatch(r"PosePrior/fc_xyz/(weights|biases)", key)
    if m:
        return ("poseprior", "out"), m.group(1)
    m = re.fullmatch(r"ViewpointNet/fc_vp(\d)/(weights|biases)", key)
    if m:
        return ("viewpoint", f"fc{m.group(1)}"), m.group(2)
    return None


def load_lifting_weights(path: str) -> Dict[str, np.ndarray]:
    """TF pickle -> {'/'-joined flax path: array} for LiftingNet.  Read only
    files you trust: this unpickles them."""
    with open(path, "rb") as f:
        weights = pickle.load(f)
    out: Dict[str, np.ndarray] = {}
    vp_axes = {}
    for key, w in weights.items():
        w = np.asarray(w)
        m = re.fullmatch(r"ViewpointNet/fc_vp_u([xyz])/(weights|biases)", key)
        if m:
            vp_axes[(m.group(1), m.group(2))] = w
            continue
        mapped = _map_name(key)
        if mapped is None:
            continue
        path_t, leaf = mapped
        if leaf == "weights":
            out["/".join(path_t + ("kernel",))] = w  # conv HWCN == HWIO; fc (in, out)
        else:
            out["/".join(path_t + ("bias",))] = w.reshape(-1)
    # the three per-axis viewpoint heads concatenate into the 3-wide output
    # (reference ext_model_loading.py:78-91)
    if vp_axes:
        out["viewpoint/out/kernel"] = np.concatenate(
            [vp_axes[(a, "weights")].reshape(-1, 1) for a in "xyz"], axis=1)
        out["viewpoint/out/bias"] = np.concatenate(
            [vp_axes[(a, "biases")].reshape(-1) for a in "xyz"])
    return out


EXTERNAL_LOADER = {"lifting": load_lifting_weights, "lifting_rot": load_lifting_weights}


def load_external_weights(task: str, path: str) -> Dict[str, np.ndarray]:
    if task not in EXTERNAL_LOADER:
        raise KeyError(f"no external-weight loader for DATASETS.TASK={task!r} "
                       f"(the TF pickle imports into {sorted(EXTERNAL_LOADER)})")
    return EXTERNAL_LOADER[task](path)
