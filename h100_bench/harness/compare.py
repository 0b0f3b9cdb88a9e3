"""The comparisons that decide `correct`, against the plain reference.

Train cells.  The program's train step is driven from the seed through
three steps on three distinct batches; the reference follows the same three
from the same weights and batches, in float32 with TF32 off (or in the
control's precision).  Three numbers, each worst over its parts:
  - `loss_gap`: each step's |loss - reference's| / |reference's|;
  - `grad_gap`: the first step's gradient, read by the program's side from
    adam's first moment after step 1 (m = (1 - b1) g), leaf by leaf:
    |norm - reference's norm| / max(reference's norm, the median leaf's);
  - `change_gap`: each leaf's change after three steps (parameters and BN's
    running statistics), the same ratio; parameters whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding) are left out;
and two that are steadier from seed to seed, since adam turns gradients
that are nought to rounding into steps of +-lr and one small leaf can lead
the worst-leaf ratios:
  - `loss1_gap`: the first step's loss alone (no update has acted yet);
  - `grad_median_gap`: the median over the leaves of the first gradient's
    ratio;
  - `heatmap1_gap`: the first step's heatmaps (the head's output, read by
    a forward hook on the program's timed call), ||program's - reference's||
    / ||reference's|| over the rows both have.
A cell's `limits/<cell>.json` says which of these it compares.
Inference cells.  On a sample of the window's view groups drawn from the
seed:
  - `heatmap_gap`: the worst group's ||program's heatmaps - reference's|| /
    ||reference's|| (2-norms over the group's views, joints and pixels), the
    reference's computed from the same inputs and weights;
  - `keypoint_gap_px`: the program's decoded 2D joints against the
    reference's decode of the program's own heatmaps (pixels);
  - `pose_gap_mm`: the program's 3D joints against the reference's pymvg
    on that decode (mm).  A joint that the reference cannot determine
    (fewer than two views pass every threshold) is not compared; one where
    only one side is finite reads inf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..reference import geometry as refgeo
from ..reference.model import Adam

B1 = 0.9  # adam's first-moment decay, in the program and the reference
PREFIX = "reference."  # the program's name of the reference's module


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: Sequence[str]) -> List[float]:
    """|program - reference| / max(reference, median reference) of each of `names`."""
    med = float(np.median([reference[n] for n in names]))
    return [abs(program[n] - reference[n]) / max(reference[n], med, 1e-30)
            if math.isfinite(program[n]) else math.inf for n in names]


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class TrainReading:
    """What the program's side gives for the three checked steps."""

    def __init__(self):
        self.losses: List[float] = []
        self.grad_norms: Dict[str, float] = {}
        self.heatmaps1: torch.Tensor = torch.empty(0)  # the first step's, on the host
        self.change_norms: Dict[str, float] = {}


def reference_steps(cell, state, batches, device, precision: str, lr: float,
                    batch_slice=None) -> TrainReading:
    """The reference's three steps from `state` on `batches[:3]` (optionally
    each cut to `batch_slice`)."""
    z, ref = cell.sizes, cell.reference
    model = ref.build(cell.recipe, precision, state, device).train()
    params = dict(model.named_parameters())
    adam = Adam(list(params.values()), lr)
    out = TrainReading()
    for i, b in enumerate(batches[:3]):
        if batch_slice is not None:
            b = {k: v[batch_slice] for k, v in b.items()}
        locs = refgeo.sample_locations(b["KRT"], b["other_KRT"], z.heatmap_hw, z.samples,
                                       z.stride)
        heat = model(b["img"].float(), b["other_img"].float(), locs)
        loss = ref.loss(heat, b)
        for p in params.values():
            p.grad = None
        loss.backward()
        if i == 0:
            out.grad_norms = {n: float(p.grad.norm()) for n, p in params.items()}
            out.heatmaps1 = heat.detach().float().cpu()
        adam.step()
        out.losses.append(float(loss.detach()))
    with torch.no_grad():
        now = model.state_dict()
        out.change_norms = {n: float((now[n] - state[n]).norm()) for n in state
                            if state[n].is_floating_point()}
    del model, adam, params
    return out


def train_numbers(program: TrainReading, reference: TrainReading) -> Dict[str, float]:
    """The train numbers of the module docstring, `program` against `reference`."""
    losses = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
              for p, r in zip(program.losses, reference.losses)]
    g = reference.grad_norms
    med = float(np.median(list(g.values())))
    moving = [n for n in reference.change_norms if n not in g or g[n] >= 1e-3 * med]
    mine = {n: program.grad_norms.get(n, 0.0) for n in g}
    rows = min(len(program.heatmaps1), len(reference.heatmaps1))
    ref1 = reference.heatmaps1[:rows]
    grads = leaf_gaps(mine, g, list(g))
    return {"loss_gap": max(losses), "loss1_gap": losses[0], "grad_gap": max(grads),
            "grad_median_gap": float(np.median(grads)),
            "heatmap1_gap": float((program.heatmaps1[:rows] - ref1).norm() / ref1.norm()),
            "change_gap": max(leaf_gaps(program.change_norms, reference.change_norms, moving))}


def infer_reference_heatmaps(cell, state, groups: List[Dict], device, precision: str):
    """The reference's eval heatmaps (V, J, h, w) of each group, float32."""
    z = cell.sizes
    model = cell.reference.build(cell.recipe, precision, state, device).eval()
    out = []
    with torch.no_grad():
        for g in groups:
            t = {k: torch.as_tensor(g[k], device=device)
                 for k in ("img", "other_img", "KRT", "other_KRT")}
            locs = refgeo.sample_locations(t["KRT"], t["other_KRT"], z.heatmap_hw, z.samples,
                                           z.stride)
            heat = model(t["img"].permute(0, 3, 1, 2), t["other_img"].permute(0, 3, 1, 2), locs)
            out.append(heat.cpu().numpy())
    del model
    return out


def infer_numbers(cell, kept: List[Dict], ref_heatmaps: List[np.ndarray]) -> Dict[str, float]:
    """heatmap_gap, keypoint_gap_px and pose_gap_mm of the kept program
    outputs (`heatmap_pred`, `batch_locs`, `pred3d` and the group)."""
    z = cell.sizes
    conf = float(cell.recipe["KEYPOINT"].get("CONF_THRES", 0.05))
    heat_gap = kp_gap = pose_gap = 0.0
    for k, ref in zip(kept, ref_heatmaps):
        hm = np.asarray(k["heatmap_pred"], dtype=np.float64)
        heat_gap = max(heat_gap, float(np.linalg.norm(hm - ref) / max(np.linalg.norm(ref), 1e-30)))
        locs, scores = refgeo.decode_peaks(hm, z.sigma, z.stride)
        kp_gap = max(kp_gap, float(np.abs(np.asarray(k["batch_locs"]) - locs).max()))
        g = k["group"]
        pose = refgeo.triangulate_pymvg(locs, g["K"], g["RT"], scores, conf)
        got = np.asarray(k["pred3d"], dtype=np.float64)
        determined = np.isfinite(pose).all(-1)
        both = determined & np.isfinite(got).all(-1)
        if (determined & ~both).any():
            return {"heatmap_gap": heat_gap, "keypoint_gap_px": kp_gap, "pose_gap_mm": math.inf}
        if both.any():
            pose_gap = max(pose_gap, float(np.abs(got[both] - pose[both]).max()))
    return {"heatmap_gap": heat_gap, "keypoint_gap_px": kp_gap, "pose_gap_mm": pose_gap}


def judge(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each number that the cell compares beside its limit."""
    return {k: {"value": numbers[k], "limit": float(v["limit"])} for k, v in limits.items()}


def all_within(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
