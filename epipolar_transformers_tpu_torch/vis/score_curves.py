"""Epipolar matching-score curve tooling (headless).

Equivalent of the reference's notebook visualization stack
(scripts/hm36_visualization.py + vis_hm36_score.ipynb, ~530 LoC): for a
chosen reference-view point, plot the per-sample matching-score curves along
its epipolar line — learned feature matching (the attention weights), raw RGB
matching (Lab ab-channel dot products, hm36_visualization.py:84-101), and an
optional non-fusion baseline — plus the ref/other view panels with the line,
the argmax correspondence and the ground truth overlaid
(Complex_Draw.draw, hm36_visualization.py:103-237).

Everything renders through matplotlib Agg into PNG files; the interactive
"click a point" loop lives in vis/cursor.py (EpipolarCursor), which consumes
the same dump dict.

Port of epipolar_transformers_tpu/vis/score_curves.py.  The JAX module
converts to Lab with cv2.cvtColor(COLOR_RGB2Lab); the port computes the
8-bit sRGB -> Lab itself (`rgb_to_lab_u8`: cv2's D65 matrix, white and
fixed-point tables), within one level of cv2's (tests/test_torch_vis.py).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

import torch

from ..geometry.camera import coord2pix, denormalize_pixel

# cv2's sRGB -> XYZ (D65) matrix and its D65 white (color_lab.cpp)
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.950456, 1.0, 1.088754])
_GAMMA_SHIFT, _LAB_SHIFT = 3, 12  # the 8-bit tables' fixed point, as cv2's
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _lab_tables():
    """cv2's 8-bit tables: sRGB gamma to 255 * 8 levels, and f(t) (the cube
    root with its linear toe) at 2**15 over 3072 steps of t."""
    x = np.arange(256) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)
    gamma = np.rint(255.0 * (1 << _GAMMA_SHIFT) * lin).astype(np.int64)
    t = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (255.0 * (1 << _GAMMA_SHIFT))
    f = np.where(t < 0.008856, t * 7.787 + 16.0 / 116.0, np.cbrt(t))
    cbrt = np.rint((1 << _LAB_SHIFT2) * f).astype(np.int64)
    coeffs = np.rint((1 << _LAB_SHIFT) * _RGB2XYZ / _WHITE[:, None]).astype(np.int64)
    return gamma, cbrt, coeffs


def _descale(v, n):
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab_u8(img_uint8_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> uint8 Lab as cv2's COLOR_RGB2Lab computes it
    for 8-bit images, in its fixed point: L scaled to 0..255, a and b
    offset by 128."""
    gamma, cbrt, coeffs = _lab_tables()
    rgb = gamma[np.asarray(img_uint8_rgb, np.int64)]
    f = cbrt[_descale(rgb @ coeffs.T, _LAB_SHIFT)]
    one = 1 << _LAB_SHIFT2
    L = _descale((116 * 255 + 50) // 100 * f[..., 1] - (16 * 255 * one + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (f[..., 0] - f[..., 1]) + 128 * one, _LAB_SHIFT2)
    b = _descale(200 * (f[..., 1] - f[..., 2]) + 128 * one, _LAB_SHIFT2)
    return np.clip(np.stack([L, a, b], axis=-1), 0, 255).astype(np.uint8)


def _lab_ab(img_uint8_rgb: np.ndarray) -> np.ndarray:
    """RGB uint8 (H, W, 3) -> float (H, W, 2) Lab ab channels
    (hm36_visualization.py:46-51 matches on ab to discount luminance)."""
    return rgb_to_lab_u8(img_uint8_rgb)[..., 1:].astype(np.float64)


def rgb_matching_scores(
    img_ref: np.ndarray,
    img_other: np.ndarray,
    sample_locs: np.ndarray,
    x: float,
    y: float,
    downsample: int = 4,
) -> Dict[str, np.ndarray]:
    """RGB (Lab-ab dot product) matching curve along the epipolar line of
    image point (x, y) (reference calc_color_score,
    hm36_visualization.py:84-101).

    Args:
        img_ref/img_other: (H, W, 3) uint8 RGB full-res images.
        sample_locs: (K, h, w, 2) normalized (-1, 1) sample locations on the
            other view, indexed by ref-view feature pixel.
        x, y: ref-view point in image coords.
    Returns:
        {"scores": (K,) normalized curve, "argmax_xy": (2,) image coords of
         the best sample, "line_xy": (K, 2) image coords of every sample}
    """
    H, W = img_other.shape[:2]
    cx, cy = int(coord2pix(x, downsample)), int(coord2pix(y, downsample))
    K = sample_locs.shape[0]
    ab_ref = _lab_ab(img_ref)[int(y), int(x)]
    ab_other = _lab_ab(img_other)

    locs = sample_locs[:, cy, cx]  # (K, 2) normalized
    # (-1,1) spans the full image, so denormalize against image dims
    # (reference hm36_visualization.py:92-94)
    xy = denormalize_pixel(torch.from_numpy(np.asarray(locs, np.float64)), H, W,
                           correct=True).numpy()
    xi = np.clip(xy[:, 0].astype(int), 0, W - 1)
    yi = np.clip(xy[:, 1].astype(int), 0, H - 1)
    scores = np.einsum("kc,c->k", ab_other[yi, xi], ab_ref)
    total = scores.sum()
    norm = scores / total if abs(total) > 1e-12 else scores
    best = int(np.argmax(scores))
    return {"scores": norm, "argmax_xy": xy[best], "line_xy": xy,
            "argmax_idx": np.int64(best)}


def score_curves(
    dump: Dict[str, np.ndarray],
    x: float,
    y: float,
    item: int = 0,
    baseline_dump: Optional[Dict[str, np.ndarray]] = None,
    img_ref: Optional[np.ndarray] = None,
    img_other: Optional[np.ndarray] = None,
    downsample: int = 4,
) -> Dict[str, np.ndarray]:
    """Assemble every matching-score curve for ref-view image point (x, y).

    `dump` is an epipolar introspection dict (vis/visualization.py::
    epipolar_introspection): attention (N, K, h, w), sample_locs
    (N, K, h, w, 2) or (K, h, w, 2), corr_pos (N, h, w, 2).
    """
    cx, cy = int(coord2pix(x, downsample)), int(coord2pix(y, downsample))
    sl = np.asarray(dump["sample_locs"])
    if sl.ndim == 5:
        sl = sl[item]
    curves: Dict[str, np.ndarray] = {
        "feat_matching": np.asarray(dump["attention"])[item][:, cy, cx],
    }
    if baseline_dump is not None:
        curves["baseline_matching"] = (
            np.asarray(baseline_dump["attention"])[item][:, cy, cx])
    out: Dict[str, np.ndarray] = dict(curves)
    if img_ref is not None and img_other is not None:
        rgb = rgb_matching_scores(img_ref, img_other, sl, x, y, downsample)
        out["rgb_matching"] = rgb["scores"]
        out["rgb_argmax_xy"] = rgb["argmax_xy"]
        out["line_xy"] = rgb["line_xy"]
    if "corr_pos" in dump:
        out["corr_xy"] = np.asarray(dump["corr_pos"])[item][cy, cx]
    return out


def draw_score_panel(
    dump: Dict[str, np.ndarray],
    x: float,
    y: float,
    out_path: str,
    item: int = 0,
    img_ref: Optional[np.ndarray] = None,
    img_other: Optional[np.ndarray] = None,
    baseline_dump: Optional[Dict[str, np.ndarray]] = None,
    downsample: int = 4,
) -> str:
    """Render the reference-notebook score panel headlessly to a PNG
    (Complex_Draw.draw, hm36_visualization.py:212-237): ref view with the
    clicked point, other view with the epipolar line + matched points, and
    the log-scale similarity curves."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    curves = score_curves(dump, x, y, item=item, baseline_dump=baseline_dump,
                          img_ref=img_ref, img_other=img_other,
                          downsample=downsample)

    n_img = int(img_ref is not None) + int(img_other is not None)
    fig, axes = plt.subplots(1, n_img + 1, figsize=(4 * (n_img + 1), 4))
    axes = np.atleast_1d(axes)
    i = 0
    if img_ref is not None:
        axes[i].imshow(img_ref)
        axes[i].scatter([x], [y], c="g", s=30)
        axes[i].set_title("reference view (g: query)")
        axes[i].axis("off")
        i += 1
    if img_other is not None:
        axes[i].imshow(img_other)
        if "line_xy" in curves:
            axes[i].plot(curves["line_xy"][:, 0], curves["line_xy"][:, 1],
                         "-", c="#0066cc", lw=1, label="epipolar line")
            axes[i].scatter(*curves["rgb_argmax_xy"], c="#0066cc", s=25,
                            label="rgb argmax")
        if "corr_xy" in curves:
            axes[i].scatter(*curves["corr_xy"], c="r", s=25, label="feat argmax")
        axes[i].legend(loc="lower right", fontsize=7)
        axes[i].set_title("other view")
        axes[i].axis("off")
        i += 1
    ax = axes[i]
    colors = {"feat_matching": "r", "rgb_matching": "#0066cc",
              "baseline_matching": "y"}
    for label in ("feat_matching", "rgb_matching", "baseline_matching"):
        if label in curves:
            c = np.asarray(curves[label], np.float64)
            ax.plot(np.arange(len(c))[1:-1], np.maximum(c, 1e-12)[1:-1],
                    color=colors[label], label=label.replace("_", " "))
    ax.set_yscale("log")
    ax.set_ylabel("similarity (log)")
    ax.set_xlabel("sample index along epipolar line")
    ax.legend(fontsize=7)
    fig.suptitle(f"x={x:.1f} y={y:.1f}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=110)
    plt.close(fig)
    return out_path
