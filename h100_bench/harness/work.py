"""The benchmark's own work arithmetic: the chip's published peaks, the
least time of the epipolar attention (its roofline) and of the attention
calls of a window.  A reference module's `attention_bound` bounds one call
of its model; the `model` reference's is `attention_bound` here.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s for
bf16 and fp16 inputs, 495 TFLOP/s for float32 inputs (TF32 on the tensor
cores, the fastest any float32 implementation can go), 3.35 TB/s of HBM.

The attention's least time (a frozen form of the port's first roofline,
`chip_smoke.py:live_pairs` and `bound`, with its work taken on the
reference's sample locations): each distinct (query, key row) pair that a
bilinear corner of non-zero weight touches costs 2 C flops each time the
function reads that row, twice in the forward (similarity, weighted sum)
and five times in the backward (similarity, the weights' gradient, the
query's gradient, and the keys' and the values' gradients); each input
byte is read once and each output byte written once, at its own element
size.  The least time is the larger of flops / peak and bytes / bandwidth.
"""

from __future__ import annotations

from typing import Dict

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def live_pairs(locs: torch.Tensor) -> int:
    """Distinct (query, key row) pairs touched with non-zero bilinear weight
    by (B, K, H, W, 2) normalized (align-corners) sample locations."""
    B, K, H, W, _ = locs.shape
    x = (locs[..., 0].double() + 1.0) / 2.0 * (W - 1)
    y = (locs[..., 1].double() + 1.0) / 2.0 * (H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            wx = (x - x0) if dx else (1.0 - (x - x0))
            wy = (y - y0) if dy else (1.0 - (y - y0))
            ok = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1) & (wx * wy != 0)
            rows.append(torch.where(ok, cy * W + cx, -1.0))
    r = torch.stack(rows, -1)  # (B, K, H, W, 4)
    r = r.permute(0, 2, 3, 1, 4).reshape(B, H * W, K * 4)
    r = torch.sort(r, dim=-1).values
    new = torch.ones_like(r, dtype=torch.bool)
    new[..., 1:] = r[..., 1:] != r[..., :-1]
    return int((new & (r >= 0)).sum())


def attention_bound(locs: torch.Tensor, channels: int, dtype: str,
                    backward: bool) -> Dict[str, float]:
    """The least seconds of one attention call at these locations, with C
    channels handed to the kernel in `dtype`: {"seconds", "flops", "bytes",
    "bound_by"}.  The keys are the values (the hand kernel's fusion, with
    shared key and value weights).  The forward reads queries, keys and
    locations and writes the output and the (B, K, HW) float32 weights; the
    backward reads queries, keys, locations and the output's gradient and
    writes the queries' and the keys' gradients."""
    B, K, H, W, _ = locs.shape
    e = ELEMENT_BYTES[dtype]
    feature = B * H * W * channels * e
    if backward:  # queries, keys, the output's gradient; a gradient of each of two
        nbytes = 5 * feature + locs.numel() * 4
    else:  # queries, keys; the output and the (B, K, HW) weights written
        nbytes = 3 * feature + locs.numel() * 4 + B * K * H * W * 4
    flops = live_pairs(locs) * 2 * channels * (5 if backward else 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes), "flops": float(flops), "bytes": float(nbytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def window_bounds(cell, cameras, first: int, end: int, backward: bool) -> Dict[str, float]:
    """The least seconds of the attention calls of window calls `first` to
    `end`, where call k runs on `cameras[k % len(cameras)]` (its (KRT,
    other_KRT) pair), at the reference's locations, each call's as the
    cell's reference module bounds it: {"forward"} and, with `backward`,
    {"backward"}."""
    from ..reference.geometry import sample_locations

    z, ref = cell.sizes, cell.reference
    dtype = cell.config["attention_dtype"]
    out = {"forward": 0.0, **({"backward": 0.0} if backward else {})}
    for i, (krt, other) in enumerate(cameras):
        uses = sum(1 for k in range(first, end) if k % len(cameras) == i)
        if not uses:
            continue
        locs = sample_locations(krt, other, z.heatmap_hw, z.samples, z.stride)
        for phase in out:
            out[phase] += uses * ref.attention_bound(locs, cell.recipe, dtype,
                                                     backward=phase == "backward")["seconds"]
    return out
