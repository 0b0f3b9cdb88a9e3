"""Cells cut to a size a CPU test run holds: R-50 (R-18 where asked) at
64 px, 16x16 heatmaps, 5 joints, K=8, batch 2, a pool of 4.  Importing it
gives torch two threads, so that several test workers on one host do not
oversubscribe its cores."""

from __future__ import annotations

import copy
from typing import Dict

import torch

from h100_bench.harness import spec

torch.set_num_threads(2)


def tiny_recipe(recipe: Dict, dtype: str = "float32", body: str = "epipolarposeR-50") -> Dict:
    """A copy of `recipe` cut to the tiny size."""
    r = copy.deepcopy(recipe)
    r["DATASETS"]["IMAGE_SIZE"] = [64, 64]
    r["KEYPOINT"].update(HEATMAP_SIZE=[16, 16], NUM_PTS=5, SIGMA=2.0)
    r["EPIPOLAR"]["SAMPLESIZE"] = 8
    r["BACKBONE"]["BODY"] = body
    r["SOLVER"]["IMS_PER_BATCH"] = 2
    r["DTYPE"] = dtype
    return r


def tiny_cell(name: str, dtype: str = "float32", body: str = "epipolarposeR-50") -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config["recipe"] = tiny_recipe(cell.recipe, dtype, body)
    cell.config["precision"] = dtype
    t = cell.traffic
    if "frame_hw" in t["rig"]:
        t["rig"].update(frame_hw=[250, 250], focal_px=290.0)
    else:
        t["rig"]["focal_px"] = 256.0
    t.update(batches=4, groups=4, warmup_groups=2, checked_groups=2)
    return cell
