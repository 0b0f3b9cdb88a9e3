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
A cell over several ranks adds two faults of data parallelism:
- `local_moments`: the reference with each BatchNorm on one rank's rows
  alone and the gradients averaged over the ranks (DDP without the BN
  exchange), rank 0's rows and running statistics compared;
- `a_rank_skips_a_step`: `rank_gap` of a rank whose second update is
  undone: each leaf's change in the reference's second step over the leaf
  after the third.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def local_moment_steps(cell, state, batches, device, lr: float, ranks: int, states=None):
    """The float32 reference's three steps with each BN on one rank's rows
    (of `ranks` equal shares) and the ranks' gradients averaged: a
    `compare.TrainReading` of rank 0's rows and statistics.  With `states`,
    append the floating state after each step."""
    import torch

    from h100_bench.harness import compare
    from h100_bench.reference import geometry as refgeo
    from h100_bench.reference import model as refmodel

    z = cell.sizes
    model = refmodel.build(z.depth, z.joints, "float32", state, device).train()
    params = dict(model.named_parameters())
    adam = refmodel.Adam(list(params.values()), lr)
    out = compare.TrainReading()
    for i, b in enumerate(batches[:3]):
        n = len(b["img"]) // ranks
        for p in params.values():
            p.grad = None
        losses, kept = [], {}
        for r in range(ranks):
            part = {k: v[r * n:(r + 1) * n] for k, v in b.items()}
            locs = refgeo.sample_locations(part["KRT"], part["other_KRT"], z.heatmap_hw,
                                           z.samples, z.stride)
            heat = model(part["img"].float(), part["other_img"].float(), locs)
            loss = refmodel.joints_mse(heat, part["heatmap"].float(),
                                       part["visibility"].float())
            (loss / ranks).backward()
            losses.append(float(loss.detach()))
            if r == 0:  # rank 0's running statistics
                kept = {k: v.clone() for k, v in model.named_buffers()}
                if i == 0:
                    out.heatmaps1 = heat.detach().float().cpu()
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(kept[k])
        if i == 0:
            out.grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
        adam.step()
        out.losses.append(sum(losses) / ranks)
        if states is not None:
            states.append({k: v.detach().clone() for k, v in model.state_dict().items()
                           if v.is_floating_point()})
    with torch.no_grad():
        now = model.state_dict()
        out.change_norms = {k: float((now[k] - state[k]).norm()) for k in state
                            if state[k].is_floating_point()}
    del model, adam, params
    return out


def skipped_step_gap(cell, state, batches, device, lr: float) -> float:
    """`rank_gap` of a rank whose second update is undone: the largest over
    the leaves of ||change in step 2|| / ||leaf after step 3||."""
    states = []
    local_moment_steps(cell, state, batches, device, lr, 1, states)
    s1, s2, s3 = states
    return max(float((s2[k] - s1[k]).norm() / s3[k].norm().clamp(min=1e-30)) for k in s3)


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
            if cell.chips > 1:
                local = local_moment_steps(cell, state, batches, device, lr, cell.chips)
                line["local_moments"] = compare.train_numbers(local, ref)
                line["a_rank_skips_a_step"] = {
                    "rank_gap": skipped_step_gap(cell, state, batches, device, lr)}
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
