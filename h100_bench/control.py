"""The readings that the limits of `limits/<cell>.json` are set from,
beside the program's own (which every run prints): the control and the
faults, on the card at the cell's own size.

    python3 h100_bench/control.py --workload <cell> --seeds 11 12 13

For each seed it prints one JSON line of the cell's numbers for:
- `control`: the reference put in the program's place and computed one
  precision below the configuration's (its `control_precision`: float8
  convolutions for a bfloat16 configuration, bfloat16 for float32 under
  TF32), against the float32 reference; an inference cell's control also
  decodes in bfloat16 and triangulates in float32;
- train cells, `half_batch`: the reference's three steps on the first half
  of each batch (the mean taken over it), against the whole batch's;
- train cells, `own_precision`: the reference at the configuration's own
  precision (bfloat16 convolutions, or TF32 for float32), against the
  float32 reference: what rounding alone gives, beside the program's.
A state left unchanged reads 1 on `change_gap` by the measure itself.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench.harness import compare, inputs, spec
    from h100_bench.harness.train import reference_state

    if not torch.cuda.is_available():
        print("control: torch sees no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, ROOT)
    recipe, traffic = cell.recipe, cell.traffic
    low = cell.config["control_precision"]
    compare.set_tf32(False)
    for seed in args.seeds:
        state = reference_state(cell, seed, device)
        rig = inputs.Rig(traffic, recipe, seed, device)
        line = {"workload": cell.name, "seed": seed}
        if traffic["kind"] == "train":
            batch = int(recipe["SOLVER"]["IMS_PER_BATCH"])
            batches = inputs.train_batches(rig, batch, traffic["batches"])[:3]
            lr = float(recipe["SOLVER"]["BASE_LR"])
            ref = compare.reference_steps(cell, state, batches, device, "float32", lr)
            ctl = compare.reference_steps(cell, state, batches, device, low, lr)
            half = compare.reference_steps(cell, state, batches, device, "float32", lr,
                                           batch_slice=slice(0, batch // 2))
            compare.set_tf32(True)  # a float32 configuration computes in TF32
            own = compare.reference_steps(cell, state, batches, device,
                                          cell.config["precision"], lr)
            compare.set_tf32(False)
            line["control"] = compare.train_numbers(ctl, ref)
            line["half_batch"] = compare.train_numbers(half, ref)
            line["own_precision"] = compare.train_numbers(own, ref)
        else:
            groups = inputs.infer_groups(rig, traffic["groups"])[:traffic["checked_groups"]]
            ref = compare.infer_reference_heatmaps(cell, state, groups, device, "float32")
            ctl = compare.infer_reference_heatmaps(cell, state, groups, device, low)
            z = cell.sizes
            conf = float(recipe["KEYPOINT"].get("CONF_THRES", 0.05))
            kept = []
            for g, hm in zip(groups, ctl):
                locs, scores = compare.refgeo.decode_peaks(hm, z.sigma, z.stride,
                                                           dtype=torch.bfloat16)
                pose = compare.refgeo.triangulate_pymvg(locs, g["K"], g["RT"], scores, conf,
                                                        dtype="float32")
                kept.append({"heatmap_pred": hm, "batch_locs": locs, "pred3d": pose,
                             "group": g})
            line["control"] = compare.infer_numbers(cell, kept, ref)
        print(json.dumps(line), flush=True)
        del state, rig
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
