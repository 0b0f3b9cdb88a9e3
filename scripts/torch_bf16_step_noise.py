#!/usr/bin/env python3
"""How far correct and faulty attentions move the bf16 train-step check.

    python3 scripts/torch_bf16_step_noise.py [--seeds 5] [--out FILE]

Runs on the card (a minute or two; builds the attention kernels first).
chip_smoke.py [12](b) holds one train step of multiview_img_lifting_rot
(epipolarposeR-50 at the flagship's widths, bf16 convolutions, batch 8)
on the kernel path against the plain path, by the relative L2 error of
the whole model's gradient.  Under bf16 convolutions any f32-level
difference in the attention's output flips bf16 roundings downstream, so
the error depends on the weights.  For `--seeds` random weight states,
each before and after three train steps on cuDNN's default algorithms,
this prints the whole-model gradient's relative L2 error against the
plain path (f32 attention) of:

  - the kernel path (what the check reads);
  - chip_smoke.rounding_references: correct attentions that differ from
    the plain one by rounding alone (in f64; its output jittered by 1e-6
    relative noise, three seeds), whose largest reading the check's limit
    scales with;
  - the plain path with f32 convolutions: bf16's own rounding;
  - three faulty attentions: the kernel with the last of the K samples
    dropped (moved out of the image), with every sample shifted by half a
    pixel, and with its output off by 1e-3 relative (seeded noise).

Each comparison runs on cuDNN's deterministic algorithms, as the check
does, so that the paths differ by their attention alone.  The card's
name and power limit head the output; `--out` also writes the readings
as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the repo root on the path first)

STEPS_BETWEEN = 3
FAULT_SCALE = 1e-3


def attentions():
    """{name: attention function}: the plain path's references and the
    faults, each with `epipolar_attention_batch`'s contract."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    kernel = attn.epipolar_attention_batch

    def drop_last_sample(f1, f2, f3, locs, params, prior=None):
        locs = locs.clone()
        locs[:, -1] = 2.0  # outside (-1, 1): every corner weight 0
        return kernel(f1, f2, f3, locs, params, prior)

    def half_pixel(f1, f2, f3, locs, params, prior=None):
        W = locs.shape[3]
        return kernel(f1, f2, f3, locs + 1.0 / W, params, prior)  # 2/W a pixel

    def noisy_output(f1, f2, f3, locs, params, prior=None):
        out, corr, depth = kernel(f1, f2, f3, locs, params, prior)
        gen = torch.Generator(device=out.device).manual_seed(smoke.SEED + 7)
        noise = torch.randn(out.shape, device=out.device, generator=gen)
        return out * (1 + FAULT_SCALE * noise).to(out.dtype), corr, depth

    return {"kernel": kernel, **smoke.rounding_references(),
            "fault: last sample dropped": drop_last_sample,
            "fault: half-pixel shift": half_pixel,
            f"fault: output off by {FAULT_SCALE:g} relative": noisy_output}


def readings(model, model32, inputs, fns) -> dict:
    """The whole-model gradient's relative L2 error of each attention in
    `fns` (and of the f32-convolution model) against the plain path."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    def whole(grads):
        return torch.cat([g.flatten() for g in grads.values()])

    with smoke.cudnn_deterministic():
        with smoke.attention_via(model, attn.epipolar_attention_plain_batch):
            _, ref = smoke.step_grads(model, inputs)
        out = {}
        for name, fn in fns.items():
            with smoke.attention_via(model, fn):
                _, got = smoke.step_grads(model, inputs)
            out[name] = smoke.rel_l2(whole(got), whole(ref))
        model32.load_state_dict(model.state_dict())
        with smoke.attention_via(model32, attn.epipolar_attention_plain_batch):
            _, got = smoke.step_grads(model32, inputs)
        out["plain f32 convolutions"] = smoke.rel_l2(whole(got), whole(ref))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
    from epipolar_transformers_tpu_torch.engine import trainer

    if not torch.cuda.is_available():
        print("torch sees no GPU; this measurement runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(smoke.card_line(), flush=True)
    cfg = flagship_cfg()
    fns = attentions()
    rows = []
    for seed in range(args.seeds):
        mcfg, inputs, model = smoke.lifting_rot_case(cfg, device, seed=smoke.SEED + seed)
        model32 = trainer.build_model(update_from_dict(mcfg, {"DTYPE": "float32"}), device)
        model.train()
        model32.train()
        step = trainer.make_train_step(mcfg, model, trainer.make_optimizer(mcfg, model))
        for steps in (0, STEPS_BETWEEN):
            if steps:
                for _ in range(steps):
                    step(inputs)
            r = readings(model, model32, inputs, fns)
            rows.append({"seed": seed, "steps": steps, **r})
            print(f"seed {seed}, after {steps} steps: "
                  + ", ".join(f"{k} {v:.4g}" for k, v in r.items()), flush=True)
        del model, model32, step
        torch.cuda.empty_cache()
    names = [k for k in rows[0] if k not in ("seed", "steps")]
    summary = {k: {"min": min(r[k] for r in rows), "median": statistics.median(r[k] for r in rows),
                   "max": max(r[k] for r in rows)} for k in names}
    # what chip_smoke.py's bf16 limit scales with: each reading over the
    # largest of the rounding references' in the same weight state
    refs = list(smoke.rounding_references())
    ratios = {k: [r[k] / max(r[n] for n in refs) for r in rows] for k in names}
    print(f"over {len(rows)} weight states, min / median / max; and over the largest "
          f"rounding reference's reading in the same state:", flush=True)
    for k, s in summary.items():
        print(f"  {k}: {s['min']:.4g} / {s['median']:.4g} / {s['max']:.4g}; "
              f"{min(ratios[k]):.3g} / {statistics.median(ratios[k]):.3g} / "
              f"{max(ratios[k]):.3g}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smoke.card_line(), "rows": rows,
                                              "summary": summary, "ratios": ratios}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
