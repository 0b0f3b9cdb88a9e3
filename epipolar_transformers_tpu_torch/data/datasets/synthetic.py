"""Synthetic multi-view pose dataset (numpy, deterministic).

Port of epipolar_transformers_tpu/data/datasets/synthetic.py with its
helpers taken from this package, so that it imports no JAX; items are
bit-equal to the JAX package's (tests/test_torch_synthetic.py).

Stands in for MultiViewH36M (reference data/datasets/multiview_h36m.py) in
tests and benchmarks: a fixed ring of pinhole cameras observes randomized
skeletons; images are Gaussian joint splats with per-joint colors, so a
keypoint network can actually learn localization end-to-end.  Items follow
the reference's __getitem__ contract (joints_dataset.py:403-427 +
multiview_h36m.py:120-157): per-view dicts with img / heatmap / visibility /
KRT / K / RT / points-2d / points-3d / camera, plus the TOPK-nearest other
view attached for epipolar fusion, and all-view stacks at test time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ...config import Config
from ...geometry.camera import neighbor_cameras
from ...ops.heatmap import make_heatmap_grid
from ...ops.synthetic_render import joint_colors
from ..transforms.affine import affine_transform_pts, get_affine_transform

_CLIP = 4.60517019  # -ln(0.01), reference keypoints2d.py:30


def make_camera_ring(
    n_views: int = 4,
    radius: float = 4000.0,
    target=(0.0, 0.0, 1000.0),
    focal: float = 1000.0,
    image_size=(256, 256),
):
    """Ring of cameras looking at `target` (world mm). Returns K/R/T/RT/KRT."""
    H, W = image_size
    Ks, Rs, Ts = [], [], []
    target = np.asarray(target, dtype=np.float64)
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views + 0.3
        center = np.array([radius * np.cos(ang), radius * np.sin(ang), 1200.0 + 100.0 * i])
        z = target - center
        z /= np.linalg.norm(z)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(z, up)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        K = np.array([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]])
        Ks.append(K)
        Rs.append(R)
        Ts.append(center)
    Ks, Rs, Ts = map(np.array, (Ks, Rs, Ts))
    RTs = np.concatenate([Rs, -Rs @ Ts[..., None]], axis=-1)
    KRTs = Ks @ RTs
    return {"K": Ks, "R": Rs, "T": Ts, "RT": RTs, "KRT": KRTs, "image_size": image_size}


class SyntheticMultiview:
    """Deterministic synthetic rig; one item == one skeleton instant.

    Train items return (ref view + nearest other view); test items return all
    V views stacked with each view's nearest other view, mirroring
    multiview_h36m.py:226-252.
    """

    def __init__(self, cfg: Config, is_train: bool, n_samples: int = 256,
                 seed: int = 0, device_render: bool | None = None):
        self.cfg = cfg
        self.is_train = is_train
        self.n_samples = n_samples
        self.seed = seed
        # DATALOADER.DEVICE_RENDER: train items carry only joint coords +
        # cameras; the trainer splats img/heatmap on-device
        # (ops/synthetic_render.py) — removes the bulky pixel upload.
        if device_render is None:
            device_render = bool(cfg.DATALOADER.DEVICE_RENDER)
        self.device_render = bool(device_render) and is_train
        H, W = cfg.DATASETS.IMAGE_SIZE
        self.image_size = (int(H), int(W))
        self.num_joints = cfg.KEYPOINT.NUM_PTS
        # train-time scale/rot augmentation (reference joints_dataset.py:309-314,
        # composed into KRT exactly as cropK.dot(Rt), :334-337)
        self.scale_factor = float(cfg.DATASETS.SCALE_FACTOR)
        self.rot_factor = float(cfg.DATASETS.ROT_FACTOR)
        self.augment = is_train and (self.scale_factor > 0 or self.rot_factor > 0)
        # focal scaled to the image so skeletons (lateral extent <~400mm at
        # 4000mm range) always project in-frame
        focal = 4.0 * min(self.image_size)
        self.rig = make_camera_ring(image_size=self.image_size, focal=focal)
        self.n_views = len(self.rig["KRT"])
        rank = neighbor_cameras({i: self.rig["KRT"][i] for i in range(self.n_views)})
        self.nearest = {cam: rank[cam][0][0] for cam in rank}
        hm_h, hm_w = cfg.KEYPOINT.HEATMAP_SIZE
        self.hm_size = (int(hm_h), int(hm_w))
        self.downsample = cfg.BACKBONE.DOWNSAMPLE
        self.sigma = cfg.KEYPOINT.SIGMA
        # precompute heatmap grid (image coords / sigma')
        self._hm_grid = make_heatmap_grid(self.hm_size, self.downsample, self.sigma)
        # image-splat grid at full res, sigma 6
        self._img_grid = make_heatmap_grid(self.image_size, 1, 3.0)
        # maximally distinct per-joint colors (evenly spaced hues) so joint
        # identity is unambiguous — random colors collide and cap JDR;
        # shared with the device renderer (ops/synthetic_render.py)
        self._joint_colors = joint_colors(self.num_joints)
        # constant background: every joint's clipped-Gaussian floor exp(-clip)
        # times its color (contiguous, copied per render)
        self._img_base = np.ascontiguousarray(
            np.broadcast_to(
                self._joint_colors.sum(0) * np.float32(np.exp(-_CLIP)),
                (*self.image_size, 3),
            ).astype(np.float32)
        )

    def __len__(self):
        return self.n_samples

    # ------------------------------------------------------------ helpers
    def _skeleton(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 100003 + idx) % (2 ** 32))
        center = np.array([0.0, 0.0, 1000.0]) + rng.uniform(-80, 80, 3)
        offsets = rng.uniform(-200.0, 200.0, (self.num_joints, 3))
        return center[None] + offsets

    def _project(self, view: int, X: np.ndarray) -> np.ndarray:
        P = self.rig["KRT"][view]
        Xh = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        x = (P @ Xh.T).T
        return x[:, :2] / x[:, 2:]

    def _gauss_maps(self, grid, sigma, coords_xy, clip=_CLIP):
        """(J, h, w) Gaussian maps on a precomputed grid (keypoints2d.py:28-31).

        `grid` is (2, h, w) of (y, x) image coords already divided by
        sigma*sqrt(2); `sigma` is the matching raw sigma.  Full-grid einsum —
        kept as the reference semantics for the fast path's parity test.
        """
        yx = coords_xy[:, ::-1]  # grid rows are (y, x)
        d = yx[:, :, None, None] / (sigma * np.sqrt(2)) - grid[None]
        dist = np.einsum("jchw,jchw->jhw", d, d)
        return np.exp(-np.clip(dist, 0, clip)).astype(np.float32)

    def _windows(self, coords_xy, sigma, downsample, shape):
        """Per-joint (y0, y1, x0, x1) map-index windows outside which the
        clipped Gaussian is exactly exp(-clip) (dist >= clip)."""
        H, W = shape
        sig = sigma * np.sqrt(2.0)
        rad = int(np.ceil(sig * np.sqrt(_CLIP) / downsample)) + 2
        out = []
        for x, y in coords_xy:
            cy = (y - downsample / 2.0 + 0.5) / downsample
            cx = (x - downsample / 2.0 + 0.5) / downsample
            y0 = min(max(int(np.floor(cy)) - rad, 0), H)
            y1 = min(max(int(np.ceil(cy)) + rad + 1, 0), H)
            x0 = min(max(int(np.floor(cx)) - rad, 0), W)
            x1 = min(max(int(np.ceil(cx)) + rad + 1, 0), W)
            out.append((y0, y1, x0, x1))
        return out

    def _gauss_maps_fast(self, grid, sigma, coords_xy, downsample, clip=_CLIP):
        """Windowed equivalent of `_gauss_maps`: fill with the clip floor
        exp(-clip), then evaluate the Gaussian only on a per-joint window that
        provably contains every pixel with dist < clip.  ~100x cheaper at
        256px than the full-grid einsum, identical output (tested)."""
        _, H, W = grid.shape
        J = len(coords_xy)
        floor = np.float32(np.exp(-clip))
        out = np.full((J, H, W), floor, dtype=np.float32)
        sig = sigma * np.sqrt(2.0)
        yx = coords_xy[:, ::-1] / sig
        for j, (y0, y1, x0, x1) in enumerate(
            self._windows(coords_xy, sigma, downsample, (H, W))
        ):
            if y0 >= y1 or x0 >= x1:
                continue
            g = grid[:, y0:y1, x0:x1]
            dy = yx[j, 0] - g[0]
            dx = yx[j, 1] - g[1]
            dist = dy * dy + dx * dx
            out[j, y0:y1, x0:x1] = np.exp(-np.clip(dist, 0, clip))
        return out

    def _render_image(self, pts2d: np.ndarray) -> np.ndarray:
        """Additive color splats: background = exp(-clip)*sum(colors) (the
        clipped-Gaussian floor every joint contributes), windows add the
        in-range Gaussian minus that floor.  Equals the full
        einsum('jhw,jc->hwc') render to float tolerance."""
        H, W = self.image_size
        floor = np.float32(np.exp(-_CLIP))
        img = self._img_base.copy()
        sig = 3.0 * np.sqrt(2.0)
        yx = pts2d[:, ::-1] / sig
        for j, (y0, y1, x0, x1) in enumerate(
            self._windows(pts2d, 3.0, 1, (H, W))
        ):
            if y0 >= y1 or x0 >= x1:
                continue
            g = self._img_grid[:, y0:y1, x0:x1]
            dy = yx[j, 0] - g[0]
            dx = yx[j, 1] - g[1]
            dist = dy * dy + dx * dx
            val = np.exp(-np.clip(dist, 0, _CLIP)) - floor
            win = img[y0:y1, x0:x1]
            win += val[..., None].astype(np.float32) * self._joint_colors[j]
            # only splatted pixels can exceed 1 (the base floor sums well
            # below it), so clip windows in place instead of the full image
            np.clip(win, 0.0, 1.0, out=win)
        return img

    def _draw_aug(self):
        """Draw a train-time (scale, rotation) jitter exactly as the reference
        does (joints_dataset.py:309-314): scale ~ clip(N(1, sf), 1-sf, 1+sf),
        rotation ~ clip(N(0, rf), -2rf, 2rf) with probability 0.6 else 0."""
        sf, rf = self.scale_factor, self.rot_factor
        scale = float(np.clip(np.random.randn() * sf + 1, 1 - sf, 1 + sf))
        rotation = float(np.clip(np.random.randn() * rf, -rf * 2, rf * 2)) \
            if np.random.rand() <= 0.6 else 0.0
        return scale, rotation

    def _view_dict(self, view: int, X: np.ndarray,
                   render: bool = True) -> Dict[str, np.ndarray]:
        pts2d = self._project(view, X)
        K = self.rig["K"][view]
        KRT = self.rig["KRT"][view]
        visibility = np.ones(self.num_joints, dtype=np.float32)
        if self.augment:
            # 2D affine about the image center composed into the camera,
            # mirroring cropK = [trans; 0 0 1] @ K; KRT = cropK @ Rt
            # (joints_dataset.py:334-337) — geometry stays exact under aug.
            H, W = self.image_size
            scale, rotation = self._draw_aug()
            base_scale = np.array([W / 200.0, H / 200.0]) * scale
            trans = get_affine_transform(
                np.array([W / 2.0, H / 2.0]), base_scale, rotation, (W, H)
            )
            A = np.concatenate([trans, [[0.0, 0.0, 1.0]]], axis=0)
            K = A @ K
            KRT = A @ KRT
            pts2d = affine_transform_pts(pts2d, trans)
            inside = (
                (pts2d[:, 0] >= 0) & (pts2d[:, 0] < W)
                & (pts2d[:, 1] >= 0) & (pts2d[:, 1] < H)
            )
            visibility = inside.astype(np.float32)
        out: Dict[str, np.ndarray] = {}
        if render:
            heatmap = self._gauss_maps_fast(
                self._hm_grid, self.sigma, pts2d, self.downsample
            )  # (J, h, w)
            heatmap *= visibility[:, None, None]
            out["img"] = self._render_image(pts2d)
            out["heatmap"] = heatmap.transpose(1, 2, 0)  # (h, w, J) NHWC
        out.update({
            "visibility": visibility,
            "KRT": KRT.astype(np.float32),
            "K": K.astype(np.float32),
            "RT": self.rig["RT"][view].astype(np.float32),
            "points-2d": pts2d.astype(np.float32),
            "camera": np.int32(view),
        })
        return out

    # ------------------------------------------------------------ items
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        X = self._skeleton(idx)
        if self.is_train:
            # global RNG on purpose: a fresh ref view each epoch (the
            # reference also re-draws per visit, multiview_h36m.py:140-143);
            # idx-seeded choice would train each skeleton from ONE view only
            ref = int(np.random.randint(self.n_views))
            other = self.nearest[ref]
            render = not self.device_render
            item = self._view_dict(ref, X, render=render)
            other_item = self._view_dict(other, X, render=render)
            item.update(
                {
                    "other_KRT": other_item["KRT"],
                    "other_camera": np.int32(other),
                    "points-3d": X.astype(np.float32),
                    "action": np.int32(0),
                }
            )
            if render:
                item["other_img"] = other_item["img"]
                item["other_heatmap"] = other_item["heatmap"]
            else:
                # device-render mode: ship only the other view's joint
                # coords; ops/synthetic_render.py splats both views on-device
                item["other_points-2d"] = other_item["points-2d"]
            return item
        # test: stack all views + each view's nearest other (multiview_h36m.py:226-252)
        views = [self._view_dict(v, X) for v in range(self.n_views)]
        others = [self._view_dict(self.nearest[v], X) for v in range(self.n_views)]
        item = {k: np.stack([v[k] for v in views]) for k in views[0]}
        item["other_img"] = np.stack([o["img"] for o in others])
        item["other_KRT"] = np.stack([o["KRT"] for o in others])
        item["other_camera"] = np.stack([o["camera"] for o in others])
        item["points-3d"] = X.astype(np.float32)
        item["action"] = np.int32(0)
        return item
