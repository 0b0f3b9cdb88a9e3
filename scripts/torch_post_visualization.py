"""Headless analog of the reference's post_visualization notebook script.

Reference `scripts/post_visualization.py` loads a prediction dump
(img1/img2/depth/corr_pos_pred/sample_locs) and interactively renders, per
clicked reference-view pixel: the deep-feature matching cost-volume curve
(log scale, post_visualization.py:77-100), the epipolar sample points on the
other view with the predicted correspondence (red) and the RGB-matching
argmax (blue) (:104-135), and the RGB matching curve on a twin log axis
(:117-143).  This version consumes the introspection dump written by
`vis.visualization.epipolar_introspection` (sample_locs / corr_pos /
attention [+ optional img / other_img]) and renders the same 2x2 panel to
PNG for a list of query pixels — no display required.

Usage:
    python scripts/torch_post_visualization.py dump.pkl out_dir \
        [--points 32,32 48,16] [--item 0] [--downsample 4]

The port's copy of scripts/post_visualization.py: it reads the dump that
the port's VIS.EPIPOLAR_LINE writes (epipolar_transformers_tpu_torch/vis/
visualization.py), imports nothing of the JAX package, and imports
matplotlib only when it renders.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _denorm(locs: np.ndarray, H: int, W: int) -> np.ndarray:
    """(-1, 1) normalized -> pixel coords (reference de_normalize,
    post_visualization.py:8-19)."""
    out = np.asarray(locs, dtype=np.float64).copy()
    out[..., 0] = (out[..., 0] + 1) * (W - 1) / 2.0
    out[..., 1] = (out[..., 1] + 1) * (H - 1) / 2.0
    return out


def render_point_panel(
    dump: dict,
    x: int,
    y: int,
    out_path: str,
    item: int = 0,
    downsample: int = 4,
) -> dict:
    """Render the reference's 2x2 click panel for feature pixel (x, y).

    Returns a summary dict (peak probability, correspondence, rgb argmax)
    so tests can assert on the numbers as well as the artifact.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    sample_locs = np.asarray(dump["sample_locs"])  # (N, K, H, W, 2) or (K, H, W, 2)
    attention = np.asarray(dump["attention"])      # (N, K', H, W) or (K', H, W)
    corr_pos = np.asarray(dump.get("corr_pos")) if dump.get("corr_pos") is not None else None
    if sample_locs.ndim == 5:
        sample_locs = sample_locs[item]
    if attention.ndim == 4:
        attention = attention[item]
    if corr_pos is not None and corr_pos.ndim == 4:
        corr_pos = corr_pos[item]

    K, H, W, _ = sample_locs.shape
    img_ref = dump.get("img")
    img_other = dump.get("other_img")
    if img_ref is not None:
        img_ref = np.asarray(img_ref)
        if img_ref.ndim == 4:
            img_ref = img_ref[item]
    if img_other is not None:
        img_other = np.asarray(img_other)
        if img_other.ndim == 4:
            img_other = img_other[item]
    disp_h = img_other.shape[0] if img_other is not None else H * downsample
    disp_w = img_other.shape[1] if img_other is not None else W * downsample

    # deep-feature cost volume at the query pixel (post_visualization.py:77)
    pr_cost_volume = attention[:, y, x]
    xs = np.arange(pr_cost_volume.shape[0])

    fig, axs = plt.subplots(2, 2, squeeze=True, figsize=(12, 8))

    # (0,0) reference view + cursor crosshair
    if img_ref is not None:
        axs[0, 0].imshow(img_ref)
        cx, cy = x * downsample + downsample / 2 - 0.5, y * downsample + downsample / 2 - 0.5
    else:
        axs[0, 0].imshow(np.zeros((H, W, 3)))
        cx, cy = x, y
    axs[0, 0].axhline(cy, color="k", lw=0.8)
    axs[0, 0].axvline(cx, color="k", lw=0.8)
    axs[0, 0].set_title(f"ref view  x={x} y={y}  depth={pr_cost_volume.max():.5f}")

    # (0,1) matching-score curve, log scale (post_visualization.py:91-99)
    inner = slice(1, -1) if pr_cost_volume.shape[0] > 2 else slice(None)
    axs[0, 1].plot(xs[inner], np.maximum(pr_cost_volume[inner], 1e-12),
                   color="#fea83a", label="deep feature matching")
    axs[0, 1].set_yscale("log")
    axs[0, 1].tick_params(bottom=False, top=True, labelbottom=False, labeltop=True)

    # (1,0) other view: epipolar samples + correspondences (:104-135)
    summary = {"peak": float(pr_cost_volume.max())}
    if img_other is not None:
        axs[1, 0].imshow(img_other)
    else:
        axs[1, 0].imshow(np.zeros((disp_h, disp_w, 3)))
    line_pix = _denorm(sample_locs[:, y, x], disp_h, disp_w)
    for k in range(1, K - 1):
        axs[1, 0].add_patch(Circle((line_pix[k, 0], line_pix[k, 1]), 1,
                                   color="y", alpha=0.5))
    if corr_pos is not None:
        # corr_pos is in feature pixels; display coords need the stride
        xx, yy = corr_pos[y, x]
        dxx = xx * downsample + downsample / 2 - 0.5
        dyy = yy * downsample + downsample / 2 - 0.5
        axs[1, 0].add_patch(Circle((dxx, dyy), 2, color="r"))
        summary["corr_xy"] = (float(xx), float(yy))

    # (1,1) RGB matching curve on a log axis (:117-143)
    if img_ref is not None and img_other is not None:
        ref_point = np.asarray(img_ref, dtype=np.float64)[
            min(int(cy), img_ref.shape[0] - 1), min(int(cx), img_ref.shape[1] - 1)]
        color_score = []
        for k in range(K):
            px = int(np.clip(line_pix[k, 0], 0, disp_w - 1))
            py = int(np.clip(line_pix[k, 1], 0, disp_h - 1))
            color_score.append(float(np.dot(ref_point, np.asarray(
                img_other, dtype=np.float64)[py, px])))
        color_score = np.asarray(color_score)
        best = int(color_score.argmax())
        axs[1, 0].add_patch(Circle((line_pix[best, 0], line_pix[best, 1]), 2,
                                   color="b"))
        total = color_score.sum()
        if total > 0:
            color_score = color_score / total
        axs[1, 1].plot(np.arange(K)[inner], np.maximum(color_score[inner], 1e-12),
                       color="b", label="rgb matching")
        axs[1, 1].set_yscale("log")
        summary["rgb_argmax_xy"] = (float(line_pix[best, 0]), float(line_pix[best, 1]))
    else:
        axs[1, 1].plot(xs[inner], np.maximum(pr_cost_volume[inner], 1e-12),
                       color="#fea83a")
        axs[1, 1].set_yscale("log")

    fig.savefig(out_path, transparent=True)
    plt.close(fig)
    summary["path"] = out_path
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump", help="introspection pickle (epipolar_introspection.pkl)")
    ap.add_argument("out_dir")
    ap.add_argument("--points", nargs="*", default=None,
                    help="feature pixels as x,y (default: a 2x2 center grid)")
    ap.add_argument("--item", type=int, default=0)
    ap.add_argument("--downsample", type=int, default=4)
    args = ap.parse_args(argv)

    with open(args.dump, "rb") as f:
        dump = pickle.load(f)
    locs = np.asarray(dump["sample_locs"])
    H, W = locs.shape[-3], locs.shape[-2]
    if args.points:
        points = [tuple(int(v) for v in p.split(",")) for p in args.points]
    else:
        points = [(W // 4, H // 4), (3 * W // 4, H // 4),
                  (W // 4, 3 * H // 4), (3 * W // 4, 3 * H // 4)]

    os.makedirs(args.out_dir, exist_ok=True)
    for x, y in points:
        out = os.path.join(args.out_dir, f"panel_x{x:03d}_y{y:03d}.png")
        s = render_point_panel(dump, x, y, out, item=args.item,
                               downsample=args.downsample)
        print(s)


if __name__ == "__main__":
    main()
