#!/usr/bin/env python3
"""Registers and per-kernel device times of the port's attention kernels.

    python3 scripts/torch_attention_kernels.py [--ptxas OTHER.cu ...]

Needs one CUDA device and `nvcc`.  Prints, for
epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu and for each
other source given (e.g. an earlier revision of it), the registers, spills
and shared memory that `nvcc -Xptxas -v` reports for every kernel; then
torch.profiler's device time per kernel over 10 backward calls at the
flagship attention shape (B=8, 64x64, K=64, C=256, f32, gradients to the
queries and to keys = values), at the synthetic rig's sample locations (as
chip_smoke.py times the backward) and at random ones in (-1.3, 1.3), so
the backward's passes can be told apart.  The card's name and power limit
come first.
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
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def profile_backward(where: str) -> None:
    import torch

    from chip_smoke import rig_sample_locs
    from epipolar_transformers_tpu_torch.config import flagship_cfg
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn
    from epipolar_transformers_tpu_torch.ops.epipolar_attention import AttentionParams

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, W, K, C = 8, 64, 64, 64, 256
    f1 = torch.randn(B, H, W, C, device=dev, generator=g).requires_grad_()
    f2 = torch.randn(B, H, W, C, device=dev, generator=g).requires_grad_()
    if where == "rig":
        locs = rig_sample_locs(flagship_cfg(), B, dev)
    else:
        locs = torch.rand(B, K, H, W, 2, device=dev, generator=g) * 2.6 - 1.3
    params = AttentionParams(softmax_scale=K ** -0.5)
    out = attn.epipolar_attention_batch(f1, f2, f2, locs, params)[0]
    r = torch.randn_like(out)
    for _ in range(3):
        torch.autograd.grad(out, (f1, f2), r, retain_graph=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            torch.autograd.grad(out, (f1, f2), r, retain_graph=True)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 10 / 1000, e.count // 10)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda x: -x[1])
    print(f"  device ms per backward call at {where} locations, by kernel "
          "(torch.profiler, 10 calls):")
    for name, ms, n in rows:
        print(f"    {ms:9.4f} ms  x{n}  {name[:110]}")
    print(f"    {sum(ms for _, ms, _ in rows):9.4f} ms  total")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", nargs="*", default=[], type=Path,
                    help="other .cu sources to report registers for")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for src in [ROOT / "epipolar_transformers_tpu_torch/csrc/epipolar_attention.cu",
                *args.ptxas]:
        print(f"ptxas -v, {src.relative_to(ROOT) if src.is_relative_to(ROOT) else src}:")
        ptxas_report(src)
    for where in ("rig", "random"):
        profile_backward(where)
    return 0


if __name__ == "__main__":
    sys.exit(main())
