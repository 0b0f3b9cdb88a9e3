"""The reference that a configuration file without a `"reference"` key gets
(`reference/model.py`, through `spec.Cell.reference`) against readings
recorded from the harness before configurations named their reference
(`golden_reference.json`): for each configuration file, the state's names
and shapes, one item's forward FLOPs at the published sizes, the
attention's bounds on the traffic's first camera pair and over the first
batch's calls (`work.window_bounds`), and the seed-0 weights at
bench_tiny's cut.  Each feeds a benchmark number: the weights every
reading, the FLOPs `mfu.*`, the bounds `attn_*_roofline`."""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from h100_bench.harness import inputs, spec, weights, work
from h100_bench.reference import geometry as refgeo
from h100_bench.reference import model as refmodel
from h100_bench.tests.bench_tiny import tiny_recipe

GOLDEN = json.loads((Path(__file__).parent / "golden_reference.json").read_text())
CONFIGS = sorted(GOLDEN)


def _cell(config: str, traffic=None) -> spec.Cell:
    conf = json.loads((spec.BENCH_DIR / "configs" / f"{config}.json").read_text())
    return spec.Cell(name=config, config=conf, traffic=traffic or {}, chips=1, end_to_end=[],
                     per_layer=[], limits={})


def _shapes_digest(shapes):
    listed = [[n, list(s)] for n, s in shapes.items()]
    return {"count": len(listed),
            "elements": sum(int(torch.Size(s).numel()) for s in shapes.values()),
            "sha256": hashlib.sha256(json.dumps(listed).encode()).hexdigest()}


@pytest.mark.parametrize("config", CONFIGS)
def test_state_shapes_are_the_recorded_ones(config):
    cell = _cell(config)
    assert cell.reference is refmodel
    assert _shapes_digest(cell.reference.state_shapes(cell.recipe)) == \
        GOLDEN[config]["state_shapes"]


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_flops_are_the_recorded_ones(config):
    cell = _cell(config)
    assert cell.reference.forward_flops(cell.recipe) == GOLDEN[config]["forward_flops"]


@pytest.mark.parametrize("config", CONFIGS)
def test_seed_weights_are_the_recorded_ones(config):
    cell = _cell(config)
    ref = cell.reference
    state = weights.make_state(ref.state_shapes(tiny_recipe(cell.recipe)), 0, "cpu",
                               **getattr(ref, "weight_rules", {}))
    digest = hashlib.sha256()
    for name, t in state.items():
        digest.update(name.encode())
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == GOLDEN[config]["make_state_sha256"]


@pytest.mark.parametrize("config, traffic", [(c, t) for c in CONFIGS
                                             for t in sorted(GOLDEN[c]["attention"])])
def test_attention_bounds_are_the_recorded_ones(config, traffic):
    """On seed 0's first train batch (a rank's rows, over ranks) or first
    view group: the first camera pair's bounds and the first call's."""
    golden = GOLDEN[config]["attention"][traffic]
    t = json.loads((spec.BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
    cell = _cell(config, t)
    recipe, z = cell.recipe, cell.sizes
    rig = inputs.Rig(t, recipe, 0, "cpu")
    if t["kind"] == "train":
        batch = int(recipe["SOLVER"]["IMS_PER_BATCH"])
        b = inputs.train_batches(rig, batch, 1)[0]
        rows = batch // int(cell.config.get("ranks", 1))
        krt, other = b["KRT"][:rows], b["other_KRT"][:rows]
    else:
        g = inputs.infer_groups(rig, 1)[0]
        krt, other = torch.as_tensor(g["KRT"]), torch.as_tensor(g["other_KRT"])
    backward = t["kind"] == "train"
    locs = refgeo.sample_locations(krt[:1], other[:1], z.heatmap_hw, z.samples, z.stride)
    first = {phase: cell.reference.attention_bound(locs, recipe, cell.config["attention_dtype"],
                                                   backward=phase == "backward")
             for phase in ("forward", "backward")}
    assert first == golden["first_pair"]
    assert work.window_bounds(cell, [(krt, other)], 0, 1, backward) == golden["first_batch"]
