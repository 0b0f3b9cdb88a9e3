#!/usr/bin/env python3
"""Registers and per-kernel device times of the port's attention kernels.

    python3 scripts/torch_attention_kernels.py [--ptxas OTHER.cu ...]

Needs one CUDA device and `nvcc`.  Prints the card's name and power limit;
then, for epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu and
each other source given (e.g. an earlier revision of it), the registers,
spills, shared memory and stack that `nvcc -Xptxas -v` reports for every
kernel; then torch.profiler's device time per kernel over 10 calls at the
flagship attention shape (B=8, 64x64, K=64, C=256), at the synthetic rig's
sample locations (as chip_smoke.py times the kernels) and at random ones in
(-1.3, 1.3), so the kernels of one call can be told apart:

  - the forward, f32 at both sets of locations and bf16 at the rig's: the
    grouping, the tile kernel and the per-query kernel, with the tiles that
    took each path;
  - the backward, gradients to the queries and to keys = values: f32 at
    both sets of locations, bf16 at the rig's, and f32 at the rig's 96x96
    lines (B=8, the 384 px recipes' heatmaps): the grouping, the tile
    kernel, the per-query and CSR passes and the row reduction, with the
    tiles that took each path.

    python3 scripts/torch_attention_kernels.py --time-forward [--tree DIR]
    python3 scripts/torch_attention_kernels.py --time-backward [--tree DIR]

instead time the forward (or the backward, keys = values) alone with CUDA
events (mean of 2 x 20 calls after warm-up) through
`epipolar_attention_batch` of the package in DIR (a checkout of another
commit inside this one, e.g. unpacked with `git archive` into a directory
.gitignore lists; default this one): f32 at the rig's and at random
locations, bf16 at the rig's, and (backward) f32 at the rig's 96x96 lines.
Run it on two trees in turns (A, B, B, A) to compare them on one card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCE = ROOT / "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu"


def ptxas_report(src: Path) -> None:
    from epipolar_transformers_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", str(Path(tmp) / "lib.so"), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                    text=True).stdout.strip() or m.group(1)
        elif kernel and ("registers" in line or "spill" in line or "stack" in line):
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def flagship_inputs(where: str, dtype):
    """B=8, K=64, C=256 features and locations: "rig" and "random" at
    64x64, "rig96" the rig's lines at 96x96."""
    import torch

    from chip_smoke import rig_sample_locs
    from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
    from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, W, K, C = 8, 64, 64, 64, 256
    cfg = flagship_cfg()
    if where == "rig96":
        H = W = 96
        cfg = update_from_dict(cfg, {"DATASETS": {"IMAGE_SIZE": (384, 384)},
                                     "KEYPOINT": {"HEATMAP_SIZE": (96, 96)}})
    f1 = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    f2 = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
    if where == "random":
        locs = torch.rand(B, K, H, W, 2, device=dev, generator=g) * 2.6 - 1.3
    else:
        locs = rig_sample_locs(cfg, B, dev)
    return f1, f2, locs, AttentionParams(softmax_scale=K ** -0.5)


def profile(run, title: str) -> None:
    """torch.profiler's device ms per launch of each kernel over 10 calls of
    `run`, and its launches per call (below 1 where the profiler lost
    events: then the total is short)."""
    import torch

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / e.count / 1000, e.count / 10)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda x: -x[1] * x[2])
    print(f"  device ms per launch and launches per call, {title}, by kernel "
          "(torch.profiler, 10 calls):")
    for name, ms, n in rows:
        print(f"    {ms:9.4f} ms  x{n:g}  {name[:110]}")
    print(f"    {sum(ms * n for _, ms, n in rows):9.4f} ms  total per call")


def profile_forward(where: str, dtype) -> None:
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    f1, f2, locs, params = flagship_inputs(where, dtype)
    with torch.inference_mode():
        attn.TILE_COUNTS.clear()
        attn.epipolar_attention_batch(f1, f2, f2, locs, params)
        tile, per_query = attn.tile_counts()
        name = "f32" if dtype == torch.float32 else "bf16"
        profile(lambda: attn.epipolar_attention_batch(f1, f2, f2, locs, params),
                f"forward {name} at {where} locations (tiles: {tile} tile path, "
                f"{per_query} per-query path)")


def backward_call(where: str, dtype):
    """A call of the backward alone (keys = values, as the model has them)
    on a graph built once."""
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    f1, f2, locs, params = flagship_inputs(where, dtype)
    f1.requires_grad_()
    f2.requires_grad_()
    out = attn.epipolar_attention_batch(f1, f2, f2, locs, params)[0]
    r = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, (f1, f2), r, retain_graph=True)


def profile_backward(where: str, dtype) -> None:
    import torch

    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    run = backward_call(where, dtype)
    attn.BACKWARD_TILE_COUNTS.clear()
    run()
    tile, per_query = attn.backward_tile_counts()
    name = "f32" if dtype == torch.float32 else "bf16"
    profile(run, f"backward {name} at {where} locations (tiles: {tile} tile path, "
                 f"{per_query} per-query path)")


def time_backward(tree: Path) -> None:
    import torch

    from chip_smoke import cuda_ms

    for where, dtype in (("rig", torch.float32), ("random", torch.float32),
                         ("rig", torch.bfloat16), ("rig96", torch.float32)):
        run = backward_call(where, dtype)
        ms = [cuda_ms(run) for _ in range(2)]
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"  backward {name} at {where} locations, tree {tree}: "
              f"{sum(ms) / 2:.4f} ms ({ms[0]:.4f}, {ms[1]:.4f})")


def time_forward(tree: Path) -> None:
    import torch

    from chip_smoke import cuda_ms
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    for where, dtype in (("rig", torch.float32), ("random", torch.float32),
                         ("rig", torch.bfloat16)):
        f1, f2, locs, params = flagship_inputs(where, dtype)
        with torch.inference_mode():
            ms = [cuda_ms(lambda: attn.epipolar_attention_batch(f1, f2, f2, locs, params))
                  for _ in range(2)]
        name = "f32" if dtype == torch.float32 else "bf16"
        print(f"  forward {name} at {where} locations, tree {tree}: "
              f"{sum(ms) / 2:.4f} ms ({ms[0]:.4f}, {ms[1]:.4f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", nargs="*", default=[], type=Path,
                    help="other .cu sources to report registers for")
    ap.add_argument("--time-forward", action="store_true",
                    help="only time the forward of the package in --tree")
    ap.add_argument("--time-backward", action="store_true",
                    help="only time the backward of the package in --tree")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout inside this one whose package --time-* imports")
    args = ap.parse_args()
    tree = args.tree.resolve()
    if not tree.is_relative_to(ROOT):
        ap.error(f"--tree must lie inside {ROOT}")
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.time_forward or args.time_backward:
        if args.time_forward:
            time_forward(tree)
        if args.time_backward:
            time_backward(tree)
        return 0
    for src in [SOURCE, *args.ptxas]:
        print(f"ptxas -v, {src.relative_to(ROOT) if src.is_relative_to(ROOT) else src}:")
        ptxas_report(src)
    for where, dtype in (("rig", torch.float32), ("random", torch.float32),
                         ("rig", torch.bfloat16)):
        profile_forward(where, dtype)
    for where, dtype in (("rig", torch.float32), ("random", torch.float32),
                         ("rig", torch.bfloat16), ("rig96", torch.float32)):
        profile_backward(where, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
