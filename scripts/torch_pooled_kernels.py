#!/usr/bin/env python3
"""Time the pooled attention's backward kernels of several sources in turns.

    python3 scripts/torch_pooled_kernels.py [OTHER.cu ...]

Needs one CUDA device and `nvcc`.  Builds
epipolar_transformers_tpu_torch/csrc/epipolar_attention_pooled.cu and each
other revision of it given (e.g. a parent commit's, unpacked with `git
archive`) into libraries of their own, prints the registers and spills
`nvcc -Xptxas -v` reports for the scatter, then runs each library's
backward at the param cell's shape (B=16, 64x64, K=64 pooled to 32,
C=128, bf16 features, the synthetic rig's lines at the param recipe's
normalization; one forward's weights for all): whether two runs give the
same bits, each gradient's largest difference from the first source's over
its largest value, the backward's mean time with CUDA events (20 calls
after 3, the sources in turns A, B, B, A, four rounds) and each kernel's
device time a call from torch.profiler (10 calls).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCE = ROOT / "epipolar_transformers_tpu_torch/csrc/epipolar_attention_pooled.cu"
B, H, W, K, C = 16, 64, 64, 64, 128


def build(src: Path, out: Path) -> ctypes.CDLL:
    """Compile `src` into `out` with the package's flags and load it."""
    from epipolar_transformers_tpu_torch.ops import _build

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    kernel = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = "scatter_kernel" if "scatter_kernel" in line else None
        elif kernel and ("Used" in line or "spill" in line):
            print(f"    {kernel}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(out))
    lib.pooled_backward_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.pooled_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.pooled_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.pooled_backward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    return lib


def main() -> int:
    import torch

    from chip_smoke import card_line, cuda_ms, kernel_ms, rig_sample_locs
    from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)
    sources = [SOURCE, *map(Path, sys.argv[1:])]
    with tempfile.TemporaryDirectory() as tmp:
        libs = []
        for i, src in enumerate(sources):
            print(f"source {i}: {src}")
            libs.append(build(src, Path(tmp) / f"lib{i}.so"))

        cfg = update_from_dict(flagship_cfg(), {
            "EPIPOLAR": {"PARAMETERIZED": ("z", "theta", "phi", "g"), "POOLING": True,
                         "BOTTLENECK": 2, "ZRESIDUAL": False, "USE_CORRECT_NORMALIZE": False},
            "DATASETS": {"CAMERAS": (0, 1, 2, 3)}})
        locs = rig_sample_locs(cfg, B, device).contiguous().reshape(B, K, H * W, 2)
        gen = torch.Generator(device=device).manual_seed(7)
        q, k, v, dout = (torch.randn(B, H * W, C, device=device, generator=gen)
                         .to(torch.bfloat16) for _ in range(4))
        stream = torch.cuda.current_stream(device).cuda_stream
        weights = torch.empty(B, K // 2, H * W, device=device)
        out, rank = torch.empty_like(q), torch.empty(B, H * W, device=device)
        if libs[0].pooled_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), locs.data_ptr(),
                                  out.data_ptr(), weights.data_ptr(), rank.data_ptr(),
                                  B, H, W, K, C, 1, 0.125, stream):
            raise RuntimeError("pooled_forward failed")

        calls, grads = [], []
        for i, lib in enumerate(libs):
            scratch = torch.empty(lib.pooled_backward_scratch_bytes(B, H, W, K),
                                  dtype=torch.uint8, device=device)
            got = [torch.empty_like(q) for _ in range(3)]

            def call(lib=lib, scratch=scratch, got=got):
                if lib.pooled_backward(q.data_ptr(), k.data_ptr(), v.data_ptr(), locs.data_ptr(),
                                       weights.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
                                       *(t.data_ptr() for t in got), B, H, W, K, C, 1, 0.125,
                                       stream):
                    raise RuntimeError("pooled_backward failed")
            call()
            first = [t.clone() for t in got]
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(first, got))
            diffs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                     for a, b in zip(first, grads[0] if grads else first)]
            print(f"source {i}: scratch {scratch.numel()} B; two runs bit-equal {same}; "
                  f"against source 0 (dq, dk, dv) " + ", ".join(f"{d:.3g}" for d in diffs))
            calls.append(call)
            grads.append(first)

        times = [[] for _ in libs]
        order = list(range(len(libs)))
        for turn in range(4):
            for i in (order if turn % 2 == 0 else order[::-1]):
                times[i].append(cuda_ms(calls[i]))
        for i, ts in enumerate(times):
            kernels = {name: kernel_ms(calls[i], name) for name in
                       ("query_kernel", "bucket_kernel", "scan_kernel", "scatter_kernel")}
            print(f"source {i}: backward {sum(ts) / len(ts):.4f} ms (" +
                  ", ".join(f"{t:.4f}" for t in ts) + "); a call: " +
                  ", ".join(f"{name} {ms:.4f}" for name, ms in kernels.items()) + " ms")
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
