"""`BENCHMARK.json` and the files it names, found by name.

- `configs/<config>.json` (the path `BENCHMARK.json` gives): the recipe as
  the port's config takes it, its precision, peak and control precision;
- `traffic/<traffic>.json`: what the window drives (read by harness/inputs.py
  and the driver of its `kind`);
- `metrics/<metric>.py`: one reader per metric, `read(run) -> float | None`;
- `limits/<cell>.json`: each number the cell compares, with its limit and
  the readings it was set from;
- `reference/<reference>.py`: the plain reference module that the
  configuration's `"reference"` key names (`model` without the key), whose
  contract `reference/__init__.py` states.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Sizes(NamedTuple):
    """The sizes of a recipe that the harness's geometry and decode use; the
    model's own (trunk, joints, widths) are its reference module's."""

    samples: int  # K, along each epipolar line
    image_hw: Tuple[int, int]
    heatmap_hw: Tuple[int, int]
    stride: int  # of the heatmaps in image pixels
    sigma: float  # of the target heatmaps and the decode window


def sizes(recipe: Dict) -> Sizes:
    return Sizes(samples=int(recipe["EPIPOLAR"]["SAMPLESIZE"]),
                 image_hw=tuple(recipe["DATASETS"]["IMAGE_SIZE"]),
                 heatmap_hw=tuple(recipe["KEYPOINT"]["HEATMAP_SIZE"]),
                 stride=int(recipe["BACKBONE"].get("DOWNSAMPLE", 4)),
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

    @property
    def reference(self) -> ModuleType:
        """The plain reference module that the configuration names."""
        return reference_module(self.config.get("reference", "model"))


def reference_module(name: str) -> ModuleType:
    """The module `reference/<name>.py`."""
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", name) or \
            not (BENCH_DIR / "reference" / f"{name}.py").is_file():
        raise ValueError(f"the configuration names the reference {name!r}: there is no "
                         f"reference/{name}.py")
    return importlib.import_module(f"..reference.{name}", __package__)


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
