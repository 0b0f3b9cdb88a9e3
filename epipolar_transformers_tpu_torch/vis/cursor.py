"""Interactive epipolar-line cursor (matplotlib-event based).

Equivalent of the reference's `Cursor*` classes (vision/visualization.py:
23-166): hover a pixel in the reference view and see its epipolar sample
points + attention weights in the other view.  Works on any matplotlib
backend (headless Agg included — events can be synthesized), consuming the
data dump produced by `vis.visualization.epipolar_introspection`.

The port's own copy of epipolar_transformers_tpu/vis/cursor.py.
"""

from __future__ import annotations

import numpy as np


class EpipolarCursor:
    """Two-axes hover tool.

    Args:
        ax_ref / ax_other: matplotlib axes showing the two views.
        sample_locs: (K, H, W, 2) normalized sample locations for item 0.
        attention: (K', H, W) attention weights.
        downsample: feature stride (display images are full resolution).
    """

    def __init__(self, ax_ref, ax_other, sample_locs, attention, downsample=4):
        self.ax_ref = ax_ref
        self.ax_other = ax_other
        self.sample_locs = np.asarray(sample_locs)
        self.attention = np.asarray(attention)
        self.downsample = downsample
        K, H, W, _ = self.sample_locs.shape
        self.H, self.W = H, W
        self._scatter = None
        self._marker = None

    def connect(self, fig):
        fig.canvas.mpl_connect("motion_notify_event", self.on_move)
        return self

    def _denorm(self, locs):
        x = (locs[..., 0] + 1) / 2 * (self.W - 1)
        y = (locs[..., 1] + 1) / 2 * (self.H - 1)
        # feature pixels -> display (full-res) coords
        d = self.downsample
        return x * d + d / 2 - 0.5, y * d + d / 2 - 0.5

    def on_move(self, event):
        if event.inaxes is not self.ax_ref or event.xdata is None:
            return
        # display coords -> feature pixel
        d = self.downsample
        fx = int(np.clip((event.xdata + 0.5 - d / 2) / d, 0, self.W - 1))
        fy = int(np.clip((event.ydata + 0.5 - d / 2) / d, 0, self.H - 1))
        locs = self.sample_locs[:, fy, fx]  # (K, 2)
        xs, ys = self._denorm(locs)
        weights = self.attention[: len(xs), fy, fx]
        sizes = 4 + 60 * (weights - weights.min()) / (np.ptp(weights) + 1e-9)
        if self._scatter is not None:
            self._scatter.remove()
        if self._marker is not None:
            self._marker.remove()
        self._scatter = self.ax_other.scatter(xs, ys, s=sizes, c="red")
        self._marker = self.ax_ref.scatter(
            [event.xdata], [event.ydata], s=30, c="lime", marker="x"
        )
        if event.canvas is not None:
            event.canvas.draw_idle()
        return fx, fy, xs, ys, weights


def show_epipolar_cursor(img_ref, img_other, dump, downsample=4, item=0):
    """Open (or render) the interactive figure from an introspection dump."""
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 5))
    ax1.imshow(img_ref)
    ax1.set_title("reference view (hover)")
    ax2.imshow(img_other)
    ax2.set_title("other view: epipolar samples")
    cursor = EpipolarCursor(
        ax1, ax2, dump["sample_locs"][item], dump["attention"][item], downsample
    ).connect(fig)
    return fig, cursor
