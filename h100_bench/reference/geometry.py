"""Plain geometry of the benchmark's reference: epipolar sample locations,
the soft-argmax decode and pymvg's adaptive triangulation.

Written from the published method (He et al., "Epipolar Transformers",
CVPR 2020, and its reference code's `grid2sample_locs`,
`find_tensor_peak_batch` and pymvg triangulation), in plain torch and
numpy.  It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the line-clipping tolerance of the published code (pixels)
CLIP_EPS = 1e-3
# how far before the image's first pixel a line that misses it puts its
# samples (image coordinates)
OUT_OF_IMAGE = 10000.0


def pix2coord(x, stride):
    """Feature-map index -> image coordinate at feature stride `stride`."""
    return x * stride + stride / 2.0 - 0.5


def coord2pix(y, stride):
    """Image coordinate -> feature-map index."""
    return (y + 0.5 - stride / 2.0) / stride


def _safe_div(num, den):
    """num / den with |den| floored at CLIP_EPS, keeping den's sign (0 counts
    as positive), as the published clipping does."""
    sign = torch.where(den >= 0, 1.0, -1.0).to(den.dtype)
    return num / (sign * den.abs().clamp(min=CLIP_EPS))


def sample_locations(P1: torch.Tensor, P2: torch.Tensor, feat_hw, samples: int, stride: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """(N, K, H, W, 2) locations in (-1, 1) (align-corners convention) of K
    evenly spaced samples along each feature pixel's epipolar line in the
    other view, between the first two of its crossings with the image
    rectangle (top, left, right, bottom, in that order; half-open corners).
    A line that crosses fewer than two edges puts its samples far outside.

    P1, P2: (N, 3, 4) projections of the reference and the other view, in
    image pixels.  Computed in float64, returned in `out_dtype`."""
    H, W = feat_hw
    dev = P1.device
    P1 = P1.double()
    P2 = P2.double()
    N = P1.shape[0]
    ys = pix2coord(torch.arange(H, dtype=torch.float64, device=dev), stride)
    xs = pix2coord(torch.arange(W, dtype=torch.float64, device=dev), stride)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x1 = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones(H * W, dtype=torch.float64,
                                                                  device=dev)])  # (3, HW)
    # the other view's image of each pixel's ray, and of the first camera's centre
    A, b = P1[:, :, :3], P1[:, :, 3]
    centre = torch.cat([-torch.linalg.solve(A, b), torch.ones(N, 1, dtype=torch.float64,
                                                              device=dev)], 1)  # (N, 4)
    X = torch.linalg.pinv(P1) @ x1  # (N, 4, HW)
    x2 = P2 @ X
    x2 = x2 / x2[:, 2:3]
    e2 = torch.einsum("nij,nj->ni", P2, centre)
    e2 = e2 / e2[:, 2:3]
    line = torch.linalg.cross(e2[:, :, None].expand_as(x2), x2, dim=1)  # (N, 3, HW)
    a, bb, c = line[:, 0], line[:, 1], line[:, 2]

    lo_x, hi_x = pix2coord(0.0, stride), pix2coord(W - 1.0, stride)
    lo_y, hi_y = pix2coord(0.0, stride), pix2coord(H - 1.0, stride)
    e = CLIP_EPS
    x_top = _safe_div(-(lo_y * bb + c), a)
    y_left = _safe_div(-(lo_x * a + c), bb)
    y_right = _safe_div(-(hi_x * a + c), bb)
    x_bottom = _safe_div(-(hi_y * bb + c), a)
    points = [(x_top, torch.full_like(x_top, lo_y)),
              (torch.full_like(y_left, lo_x), y_left),
              (torch.full_like(y_right, hi_x), y_right),
              (x_bottom, torch.full_like(x_bottom, hi_y))]
    valid = [(x_top >= lo_x + e) & (x_top < hi_x - e),
             (y_left > lo_y + e) & (y_left <= hi_y - e),
             (y_right >= lo_y + e) & (y_right < hi_y - e),
             (x_bottom > lo_x + e) & (x_bottom <= hi_x - e)]
    # the first two valid crossings, in edge order
    far = torch.tensor([lo_x - OUT_OF_IMAGE, lo_y - OUT_OF_IMAGE], dtype=torch.float64,
                       device=dev)
    start = far.expand(N, H * W, 2)
    end = start
    found = torch.zeros(N, H * W, dtype=torch.int64, device=dev)
    for (px, py), ok in zip(points, valid):
        p = torch.stack([px, py], -1)
        start = torch.where((ok & (found == 0))[..., None], p, start)
        end = torch.where((ok & (found == 1))[..., None], p, end)
        found = found + ok.long()
    missing = (found < 2)[..., None]
    start = torch.where(missing, far, start)
    end = torch.where(missing, far, end)
    t = torch.linspace(0.0, 1.0, samples, dtype=torch.float64, device=dev)
    locs = start[:, None] + (end - start)[:, None] * t[None, :, None, None]  # (N, K, HW, 2)
    pix = coord2pix(locs, stride)
    norm = torch.stack([2.0 * pix[..., 0] / (W - 1) - 1.0, 2.0 * pix[..., 1] / (H - 1) - 1.0], -1)
    return norm.reshape(N, samples, H, W, 2).to(out_dtype)


def decode_peaks(heatmaps: np.ndarray, radius: float, stride: int, threshold: float = 1e-6,
                 dtype=torch.float64):
    """Soft-argmax decode of (..., H, W) heatmaps in `dtype`: the argmax
    pixel, a (2r+1)^2 bilinear window around it (zero outside the map) with
    spacing radius / round(radius), values at or under `threshold` dropped,
    and the window's weighted centroid in image coordinates.  Returns
    ((..., 2) x, y and (...) the peak values), as float64 arrays."""
    # the bilinear window in at least float32, then rounded to `dtype`
    hm = torch.as_tensor(np.asarray(heatmaps, dtype=np.float64)).to(dtype)
    sample_dtype = torch.promote_types(dtype, torch.float32)
    lead = hm.shape[:-2]
    H, W = hm.shape[-2:]
    flat = hm.reshape(-1, H * W)
    idx = flat.argmax(-1)
    score = flat.gather(1, idx[:, None])[:, 0]
    cy = torch.div(idx, W, rounding_mode="floor").to(dtype)
    cx = (idx % W).to(dtype)
    steps = int(radius + 0.5)
    offs = torch.as_tensor(np.arange(-radius, radius + 1e-4, radius / steps)).to(dtype)
    R = offs.numel()
    gy = (cy[:, None, None] + offs[None, :, None]).to(sample_dtype)  # (M, R, 1)
    gx = (cx[:, None, None] + offs[None, None, :]).to(sample_dtype)  # (M, 1, R)
    grid = torch.stack([2.0 * gx.expand(-1, R, R) / (W - 1) - 1.0,
                        2.0 * gy.expand(-1, R, R) / (H - 1) - 1.0], -1)  # (M, R, R, 2)
    win = F.grid_sample(flat.reshape(-1, 1, H, W).to(sample_dtype), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)[:, 0].to(dtype)  # (M, R, R)
    win = torch.where(win > threshold, win, 0.0)
    total = win.sum((1, 2)) + float(np.finfo(np.float64).eps)
    x = (win * offs[None, None, :]).sum((1, 2)) / total + cx
    y = (win * offs[None, :, None]).sum((1, 2)) / total + cy
    xy = torch.stack([pix2coord(x, stride), pix2coord(y, stride)], -1)
    return (xy.reshape(*lead, 2).double().numpy(), score.reshape(lead).double().numpy())


def triangulate_pymvg(points: np.ndarray, Ks: np.ndarray, RTs: np.ndarray, scores: np.ndarray,
                      conf_thres: float = 0.05, dtype=np.float64) -> np.ndarray:
    """pymvg's adaptive triangulation: for each joint, lower the score
    threshold from `conf_thres` in steps of 0.05 until at least two views
    pass it (every view once it is under -1), then the direct linear
    transform over the views that pass, solved by SVD.  points (V, J, 2),
    Ks (V, 3, 3), RTs (V, 3, 4), scores (V, J) -> (J, 3), NaN where fewer
    than two views pass even then (no point is determined)."""
    pts = np.asarray(points, dtype=dtype)
    Ps = (np.asarray(Ks, dtype=np.float64) @ np.asarray(RTs, dtype=np.float64)).astype(dtype)
    scores = np.asarray(scores)
    V, J = scores.shape
    out = np.full((J, 3), np.nan)
    # the last threshold tried lies under -1
    n_steps = int(np.ceil((conf_thres + 1.0) / 0.05)) + 2
    for j in range(J):
        for k in range(n_steps):
            sel = scores[:, j] > conf_thres - 0.05 * k
            if sel.sum() > 1:
                break
        rows = []
        for v in np.flatnonzero(sel):
            x, y = pts[v, j]
            rows.append(x * Ps[v, 2] - Ps[v, 0])
            rows.append(y * Ps[v, 2] - Ps[v, 1])
        if len(rows) < 4:
            continue
        _, _, vt = np.linalg.svd(np.asarray(rows, dtype=dtype))
        h = vt[-1]
        with np.errstate(divide="ignore", invalid="ignore"):
            out[j] = (h[:3] / h[3]).astype(np.float64)
    return out
