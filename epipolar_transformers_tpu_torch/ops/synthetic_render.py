"""Rendering of the synthetic rig: splat colours and the on-device renderer.

Port of epipolar_transformers_tpu/ops/synthetic_render.py.  `joint_colors`
(numpy) is shared with the host renderer of data/datasets/synthetic.py.
Under DATALOADER.DEVICE_RENDER the train items carry the 2D joint
coordinates in place of pixels, and `make_batch_renderer` splats the
images and target heatmaps on the batch's device: full-grid clipped
Gaussians, equal to the host's windowed splats to float tolerance
(tests/test_torch_device_render.py).

Everything stays float32 and elementwise: the coordinates never pass
through a TF32 or bf16 matmul (the colour sum over joints is a
multiply-add, not an einsum).  Outputs are NCHW views of NHWC memory
(channels_last), as `engine.tester.to_model_inputs` gives the host's.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .heatmap import make_heatmap_grid

_CLIP = 4.60517019  # -ln(0.01), reference lib/utils/keypoints2d.py:30
_IMG_SIGMA = 3.0  # the host renderer's image-splat sigma

# the keys a device-render (coordinates only) batch carries in place of pixels
RENDER_PARAM_KEYS = ("points-2d", "other_points-2d")


def _hsv_to_rgb(h: float, s: float, v: float):
    i = int(h * 6) % 6
    f = h * 6 - int(h * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def joint_colors(num_joints: int) -> np.ndarray:
    """Maximally distinct per-joint splat colors (evenly spaced hues)."""
    hues = np.linspace(0.0, 1.0, num_joints, endpoint=False)
    return np.stack(
        [_hsv_to_rgb(h, 0.9, 1.0) for h in hues]
    ).astype(np.float32)


def _gauss_maps(pts2d: torch.Tensor, grid: torch.Tensor, sigma: float) -> torch.Tensor:
    """(B, H, W, J) maps exp(-clip(dist, 0, _CLIP)) of the (B, J, 2)
    full-resolution (x, y) coordinates on `grid`, the (2, H, W) (y, x)
    image coordinates divided by sigma*sqrt(2) (`make_heatmap_grid`)."""
    sig = np.float32(sigma * np.sqrt(2.0))
    yx = pts2d.flip(-1).float() / sig  # (B, J, 2)
    dy = yx[:, None, None, :, 0] - grid[0][None, :, :, None]
    dx = yx[:, None, None, :, 1] - grid[1][None, :, :, None]
    return torch.exp(-torch.clamp(dy * dy + dx * dx, 0.0, _CLIP))


def render_images(pts2d: torch.Tensor, colors: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """(B, J, 2) joint coordinates -> (B, 3, H, W) channels_last additive
    colour splats, clip(sum_j exp(-clip(dist_j)) color_j, 0, 1); `colors`
    (J, 3) f32 and `grid` (`make_heatmap_grid(image_size, 1, 3.0)`) on the
    coordinates' device."""
    maps = _gauss_maps(pts2d, grid, _IMG_SIGMA)
    img = torch.stack([(maps * colors[:, c]).sum(-1) for c in range(3)], dim=-1)
    return img.clamp_(0.0, 1.0).permute(0, 3, 1, 2)


def render_heatmaps(pts2d: torch.Tensor, visibility: torch.Tensor, grid: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """(B, J, 2) joint coordinates -> (B, J, h, w) channels_last target
    heatmaps, masked by visibility as the host's are; `grid`
    (`make_heatmap_grid(heatmap_size, downsample, sigma)`) on the
    coordinates' device."""
    maps = _gauss_maps(pts2d, grid, sigma)
    return (maps * visibility.float()[:, None, None, :]).permute(0, 3, 1, 2)


def make_batch_renderer(cfg) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """A coordinates-only batch on the device (RENDER_PARAM_KEYS, the
    cameras and the visibility) -> the model inputs: `img`, `other_img` and
    `heatmap` rendered there, the coordinate keys dropped.  The colours
    and the two grids are constants, uploaded once per device."""
    sigma = float(cfg.KEYPOINT.SIGMA)
    constants = (
        torch.from_numpy(joint_colors(cfg.KEYPOINT.NUM_PTS)),
        torch.from_numpy(make_heatmap_grid(tuple(int(s) for s in cfg.DATASETS.IMAGE_SIZE), 1,
                                           _IMG_SIGMA)),
        torch.from_numpy(make_heatmap_grid(tuple(int(s) for s in cfg.KEYPOINT.HEATMAP_SIZE),
                                           int(cfg.BACKBONE.DOWNSAMPLE), sigma)),
    )
    on_device = {}  # device -> (colors, image grid, heatmap grid)

    def render(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        pts = batch["points-2d"]
        if pts.device not in on_device:
            on_device[pts.device] = tuple(t.to(pts.device) for t in constants)
        colors, img_grid, hm_grid = on_device[pts.device]
        out = {k: v for k, v in batch.items() if k not in RENDER_PARAM_KEYS}
        out["img"] = render_images(pts, colors, img_grid)
        out["other_img"] = render_images(batch["other_points-2d"], colors, img_grid)
        out["heatmap"] = render_heatmaps(pts, batch["visibility"], hm_grid, sigma)
        return out

    return render
