"""`BENCHMARK.json` and the files it names, found by name.

- `configs/<config>.json` (the path `BENCHMARK.json` gives): the recipe as
  the port's config takes it, its precision, peak and control precision;
- `traffic/<traffic>.json`: what the window drives (read by harness/inputs.py
  and the driver of its `kind`);
- `metrics/<metric>.py`: one reader per metric, `read(run) -> float | None`;
- `limits/<cell>.json`: each number the cell compares, with its limit and
  the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Sizes(NamedTuple):
    """The sizes of a recipe that the harness and the reference use."""

    depth: int  # of the ResNet trunk
    joints: int
    samples: int  # K, along each epipolar line
    image_hw: Tuple[int, int]
    heatmap_hw: Tuple[int, int]
    stride: int  # of the heatmaps in image pixels
    channels: int  # of the features the attention is handed
    sigma: float  # of the target heatmaps and the decode window


def sizes(recipe: Dict) -> Sizes:
    return Sizes(depth=int(recipe["BACKBONE"]["BODY"].split("-")[-1]),
                 joints=int(recipe["KEYPOINT"]["NUM_PTS"]),
                 samples=int(recipe["EPIPOLAR"]["SAMPLESIZE"]),
                 image_hw=tuple(recipe["DATASETS"]["IMAGE_SIZE"]),
                 heatmap_hw=tuple(recipe["KEYPOINT"]["HEATMAP_SIZE"]),
                 stride=int(recipe["BACKBONE"].get("DOWNSAMPLE", 4)),
                 channels=int(recipe["KEYPOINT"].get("NFEATS", 256)),
                 sigma=float(recipe["KEYPOINT"]["SIGMA"]))


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict

    @property
    def recipe(self) -> Dict:
        return self.config["recipe"]

    @property
    def sizes(self) -> Sizes:
        return sizes(self.recipe)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
                limits=_json(BENCH_DIR / "limits" / f"{name}.json"))


def reader(metric: str):
    """The module `metrics/<metric>.py`."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    name = "h100_bench_metric_" + metric.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
