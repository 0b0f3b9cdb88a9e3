"""The crop's affine warp and the Gaussian target heatmaps, on the host in
numpy.

The port's own copies of JAX runtime/loader.py's `warp_affine` and
`render_heatmaps` (its native runtime/warp.cpp and the numpy fallbacks),
which the JAX H36M dataset calls per view:

  * `warp_affine(src, trans, (W, H))`: cv2.warpAffine(INTER_LINEAR,
    BORDER_CONSTANT 0) of a float32 (H, W[, C]) image in warp.cpp's
    arithmetic: the inverse of the forward 2x3 map in float64, each output
    pixel's source point in float64, its 4 bilinear weights in float32, and
    taps outside the image reading 0.
  * `render_heatmaps(coords_xy, (h, w), sigma, downsample)`: (J, h, w)
    Gaussians at the joints on the heatmap grid in image coordinates,
    sigma' = sigma sqrt(2), the squared distance clipped at -ln(0.01)
    before the exp (JAX ops/heatmap.py).

tests/test_torch_undistort.py holds both to JAX's.
"""

from __future__ import annotations

import numpy as np

from ...ops.heatmap import make_heatmap_grid

__all__ = ["render_heatmaps", "warp_affine"]

_CLIP = 4.60517019  # -ln(0.01)


def warp_affine(src: np.ndarray, trans: np.ndarray, out_size) -> np.ndarray:
    """Bilinear affine warp with a zero border.  `trans` is the forward
    (2, 3) map src -> dst; `out_size` is (W_out, H_out) as cv2 takes it.
    Returns float32 (H_out, W_out[, C])."""
    W_out, H_out = int(out_size[0]), int(out_size[1])
    src = np.asarray(src, np.float32)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    H, W, C = src.shape
    (a, b, c), (d, e, f) = np.asarray(trans, np.float64)
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    ic, if_ = -(ia * c + ib * f), -(id_ * c + ie * f)
    xs = np.arange(W_out, dtype=np.float64)[None, :]
    ys = np.arange(H_out, dtype=np.float64)[:, None]
    sx = ia * xs + ib * ys + ic
    sy = id_ * xs + ie * ys + if_
    fx, fy = np.floor(sx), np.floor(sy)
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    wx = (sx - fx).astype(np.float32)
    wy = (sy - fy).astype(np.float32)
    one = np.float32(1)
    flat = np.concatenate([src.reshape(-1, C), np.zeros((1, C), np.float32)])
    out = np.zeros((H_out, W_out, C), np.float32)
    for dy, wyv in ((0, one - wy), (1, wy)):
        for dx, wxv in ((0, one - wx), (1, wx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            tap = flat[np.where(inside, yy * W + xx, H * W)]
            # out += w * tap as one fused multiply-add, rounded once to f32
            # (the product of two f32 is exact in f64)
            w = (wyv * wxv).astype(np.float64)[..., None]
            out = (out + w * tap).astype(np.float32)
    return out[..., 0] if squeeze else out


def render_heatmaps(coords_xy: np.ndarray, hm_size, sigma: float, downsample: float,
                    visibility=None) -> np.ndarray:
    """(J, h, w) float32 Gaussian target heatmaps of (J, 2+) image-space
    (x, y) joints on an `hm_size` = (h, w) grid at stride `downsample`;
    joints whose visibility is <= 0 get a zero map."""
    H, W = int(hm_size[0]), int(hm_size[1])
    coords = np.asarray(coords_xy, np.float32)[:, :2]
    grid = make_heatmap_grid((H, W), downsample, sigma)
    sig = sigma * np.sqrt(2)
    d = coords[:, 1::-1, None, None] / sig - grid[None]
    dist = np.einsum("jchw,jchw->jhw", d, d)
    out = np.exp(-np.clip(dist, 0, _CLIP)).astype(np.float32)
    if visibility is not None:
        out[np.asarray(visibility, np.float32).reshape(-1) <= 0] = 0.0
    return out
