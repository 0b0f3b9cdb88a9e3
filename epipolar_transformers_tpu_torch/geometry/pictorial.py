"""Recursive Pictorial Structure Model (RPSM) for multiview 3D inference.

Port of epipolar_transformers_tpu/geometry/pictorial.py (reference
modeling/pictorial_cuda.py): a coarse 16^3 grid over GRID_SIZE mm around
the root -> per-bin unary terms by projecting the bins into every view's
heatmap -> pairwise limb-length constraints -> max-product inference over
the skeleton tree -> recursive 2^3 grid refinement x RECUR_DEPTH around each
joint.

The unary sampling runs on `device` (the model's), one batched
`F.grid_sample` over views x joints; the grids, the pairwise terms and the
tree max-product stay numpy on the host, as in the JAX package.  Edges whose
two joints share one grid (the first stage) share one distance matrix.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.transforms.affine import get_affine_transform
from ..ops.grid_sample import grid_sample_nhwc
from .body import HumanBody


def compute_grid(box_size: float, box_center: np.ndarray, nbins: int) -> np.ndarray:
    """(nbins^3, 3) cube of world-mm bin centers (pictorial_cuda.py:93-104)."""
    grid1d = np.linspace(-box_size / 2, box_size / 2, nbins)
    gx, gy, gz = np.meshgrid(
        grid1d + box_center[0], grid1d + box_center[1], grid1d + box_center[2],
        indexing="ij",
    )
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)


def compute_pairwise(skeleton, limb_length, grids: List[np.ndarray], tolerance: float):
    """Binary limb-length feasibility per edge (pictorial_cuda.py:126-137)."""
    pairwise, dists = {}, {}
    for node in skeleton:
        cur = node["idx"]
        for child in node["children"]:
            key = (id(grids[cur]), id(grids[child]))
            if key not in dists:
                dists[key] = np.linalg.norm(
                    grids[cur][:, None, :] - grids[child][None, :, :], axis=-1
                ) + 1e-9
            pairwise[(cur, child)] = (
                np.abs(dists[key] - limb_length[(cur, child)]) < tolerance
            ).astype(np.float32)
    return pairwise


def _sample_unary(heatmaps: torch.Tensor, grids_xy: torch.Tensor) -> torch.Tensor:
    """heatmaps (V, J, h, w); grids_xy (V, J, nbins, 2) normalized, on one
    device.  Returns the unary (J, nbins) summed over views."""
    V, J, h, w = heatmaps.shape
    samples = grid_sample_nhwc(heatmaps.reshape(V * J, h, w, 1), grids_xy.reshape(V * J, -1, 2))
    return samples.reshape(V, J, -1).sum(0)


def compute_unary_term(
    heatmaps,
    grids: List[np.ndarray],
    boxes: List[dict],
    cams: np.ndarray,
    img_size,
    correct_offset: bool = True,
    device=None,
) -> np.ndarray:
    """Project every bin into every view and sample heatmap confidence.

    reference pictorial_cuda.py:140-199.  The reference samples at
    `xy * [w, h] / imgSize`, ignoring the half-stride offset its own Gaussian
    targets are rendered with (keypoints2d.py:12-15), a ~1.5-image-px bias
    (and its [h-1, w-1] axis swap, inert on square maps).
    `correct_offset=True` (default) samples at the coord2pix-consistent
    position instead; False reproduces the reference verbatim.

    heatmaps: (V, J, h, w), a tensor or an array; the sampling runs on
    `device` (None: the tensor's own device, the CPU for an array).
    Returns (J, nbins) float32 numpy.
    """
    heatmaps = torch.as_tensor(heatmaps, device=device).float()
    V, J, h, w = heatmaps.shape
    share_grid = len(grids) == 1
    nbins = grids[0].shape[0]

    grids_xy = np.zeros((V, J, nbins, 2), dtype=np.float32)
    for v in range(V):
        trans = get_affine_transform(boxes[v]["center"], boxes[v]["scale"], 0, img_size)
        for j in range(J):
            g = grids[0] if share_grid else grids[j]
            if share_grid and j > 0:
                grids_xy[v, j] = grids_xy[v, 0]
                continue
            xy = g @ cams[v][:, :-1].T + cams[v][:, -1]
            xy = xy[:, :2] / xy[:, -1:]
            homo = np.concatenate([xy, np.ones((nbins, 1))], axis=1)
            xy = (trans @ homo.T).T[:, :2]
            if correct_offset:
                ds = np.array(img_size, dtype=np.float64) / np.array([w, h])
                pix = (xy + 0.5 - ds / 2.0) / ds  # coord2pix per axis
                sample = pix / np.array([w - 1, h - 1], dtype=np.float64) * 2.0 - 1.0
            else:
                xy = xy * np.array([w, h]) / np.array(img_size, dtype=np.float64)
                sample = xy / np.array([h - 1, w - 1], dtype=np.float64) * 2.0 - 1.0
            grids_xy[v, j] = sample
    unary = _sample_unary(heatmaps, torch.from_numpy(grids_xy).to(heatmaps.device))
    return unary.cpu().numpy()


def infer(unary: np.ndarray, pairwise: Dict, body: HumanBody, root_idx: int = 0):
    """Max-product tree inference (pictorial_cuda.py:17-71).

    unary: (J, nbins) terms. Returns sorted [(joint_idx, bin_idx)]."""
    skeleton = body.skeleton
    states = {}
    for node in body.skeleton_sorted_by_level:
        u = unary[node["idx"]].copy()
        if len(node["children"]) == 0:
            states[node["idx"]] = {"Energy": u, "State": None}
            continue
        children_state = []
        for child in node["children"]:
            pw = pairwise[(node["idx"], child)]  # (nb_parent, nb_child)
            ce = states[child]["Energy"]
            pwce = pw * ce[None, :]
            children_state.append(np.argmax(pwce, axis=1))
            u = u * np.max(pwce, axis=1)
        states[node["idx"]] = {"Energy": u, "State": np.array(children_state).T}

    pose = [[root_idx, int(np.argmax(states[root_idx]["Energy"]))]]
    queue = list(pose)
    while queue:
        joint_idx, bin_idx = queue.pop(0)
        st = states[joint_idx]["State"]
        if st is None:
            continue
        for child, b in zip(skeleton[joint_idx]["children"], st[bin_idx]):
            pose.append([child, int(b)])
            queue.append([child, int(b)])
    pose.sort()
    return pose


def get_loc_from_cube_idx(grids: List[np.ndarray], pose_bins) -> np.ndarray:
    single = len(grids) == 1
    out = np.zeros((len(pose_bins), 3))
    for joint_idx, bin_idx in pose_bins:
        out[joint_idx] = grids[0 if single else joint_idx][bin_idx]
    return out


def recursive_infer(initpose, cams, heatmaps, boxes, img_size, body,
                    limb_length, grid_size, nbins, tolerance, device=None):
    """pictorial_cuda.py:202-219."""
    grids = [compute_grid(grid_size, initpose[i], nbins) for i in range(len(initpose))]
    unary = compute_unary_term(heatmaps, grids, boxes, cams, img_size, device=device)
    pairwise = compute_pairwise(body.skeleton, limb_length, grids, tolerance)
    pose_bins = infer(unary, pairwise, body)
    return get_loc_from_cube_idx(grids, pose_bins)


def rpsm(
    cams: np.ndarray,
    heatmaps,
    center: np.ndarray,
    boxes: List[dict],
    body: HumanBody,
    limb_length: Dict,
    img_size,
    grid_size: float = 2000.0,
    first_nbins: int = 16,
    recur_nbins: int = 2,
    recur_depth: int = 10,
    tolerance: float = 150.0,
    pairwise: Optional[Dict] = None,
    root_idx: int = 0,
    device=None,
) -> np.ndarray:
    """Full RPSM (pictorial_cuda.py:222-254).

    Args:
        cams: (V, 3, 4) full-image projection matrices (origK @ RT).
        heatmaps: (V, J, h, w), a tensor or an array.
        center: (3,) root init (reference uses GT root).
        pairwise: optional precomputed first-stage constraints (the reference
            loads them from PICT_STRUCT.PAIRWISE_FILE); computed from
            limb_length when absent.
        device: where the unary sampling runs (None: the heatmaps' device).
    """
    # one copy of the heatmaps on the sampling device for every stage
    heatmaps = torch.as_tensor(heatmaps, device=device).float()
    grid = compute_grid(grid_size, center, first_nbins)
    unary = compute_unary_term(heatmaps, [grid], boxes, cams, img_size)
    if pairwise is None:
        pairwise = compute_pairwise(body.skeleton, limb_length, [grid] * len(body.skeleton),
                                    tolerance)
    pose_bins = infer(unary, pairwise, body, root_idx)
    pose3d = get_loc_from_cube_idx([grid], pose_bins)

    cur = grid_size / first_nbins
    for _ in range(recur_depth):
        pose3d = recursive_infer(pose3d, cams, heatmaps, boxes, img_size, body,
                                 limb_length, cur, recur_nbins, tolerance)
        cur = cur / recur_nbins
    return pose3d
