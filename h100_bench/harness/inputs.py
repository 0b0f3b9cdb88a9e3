"""The benchmark's one generator of inputs, driven by a traffic file.

A traffic file (`traffic/<name>.json`) gives the rig, the skeletons, the
crop and how many distinct batches or view groups to make; the cell's
configuration gives the image, heatmap and batch sizes.  The cameras are
fixed by the file; the rest is drawn as said below, the images on the
device.  Every seed gets the same sizes.

- The rig is a ring of pinhole cameras aimed at one point (the layout of the
  port's synthetic rig and fake H36M tree: `make_camera_ring`, copied).
- A skeleton is a centre jittered about the rig's target plus joint offsets,
  uniform in the file's box (millimetres).  The skeletons and the views
  (so the crops and the epipolar lines, which set how much work the
  attention does) come from the file's `geometry_seed`: every run seed gets
  the same set, in its own order, with its own images and weights.
- A train item is a reference view drawn at random and its nearest other
  camera; an inference group is every view with its nearest other.
- With `crop`, each view is cropped around its skeleton's 2D box (square,
  `box_scale` times its longer side) to the configured image size, the
  affine composed into the camera (an H36M recipe's crop); without, the
  frame is the image.
- Images are N(0, 1) noise; the target heatmaps are Gaussians of the
  configured sigma at the joints' pixels (clipped at exp(-4.605)), zero for
  a joint outside the image, whose visibility is then 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

HEATMAP_CLIP = 4.60517019  # -ln(0.01)


def make_camera_ring(n_views: int, radius: float, target, focal: float, image_hw,
                     height: float, height_step: float, angle0: float):
    """K (V, 3, 3), RT (V, 3, 4) and KRT of a ring aimed at `target`
    (world mm; camera i at angle 2 pi i / V + angle0, height
    `height + height_step * i`)."""
    H, W = image_hw
    target = np.asarray(target, dtype=np.float64)
    Ks, RTs = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views + angle0
        centre = np.array([radius * np.cos(ang), radius * np.sin(ang), height + height_step * i])
        z = target - centre
        z /= np.linalg.norm(z)
        x = np.cross(z, np.array([0.0, 0.0, 1.0]))
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Ks.append(np.array([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]]))
        RTs.append(np.concatenate([R, -R @ centre[:, None]], 1))
    K, RT = np.array(Ks), np.array(RTs)
    return {"K": K, "RT": RT, "KRT": K @ RT}


def nearest_other(KRT: np.ndarray) -> np.ndarray:
    """For each camera, the index of the camera whose centre is closest."""
    centres = np.stack([-np.linalg.solve(P[:, :3], P[:, 3]) for P in KRT])
    d = np.linalg.norm(centres[:, None] - centres[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.argmin(1)


class Rig:
    """The traffic file's rig and skeletons, for one configuration."""

    def __init__(self, traffic: Dict, recipe: Dict, seed: int, device):
        r = traffic["rig"]
        frame = tuple(r.get("frame_hw", recipe["DATASETS"]["IMAGE_SIZE"]))
        self.cams = make_camera_ring(r["views"], r["radius_mm"], r["target_mm"],
                                     r["focal_px"], frame, r["height_mm"],
                                     r["height_step_mm"], r["angle0"])
        self.views = r["views"]
        self.nearest = nearest_other(self.cams["KRT"])
        self.skeleton = traffic["skeleton"]
        self.crop = traffic.get("crop")
        self.image_hw = tuple(recipe["DATASETS"]["IMAGE_SIZE"])
        self.heatmap_hw = tuple(recipe["KEYPOINT"]["HEATMAP_SIZE"])
        self.sigma = float(recipe["KEYPOINT"]["SIGMA"])
        self.stride = int(recipe["BACKBONE"].get("DOWNSAMPLE", 4))
        self.joints = int(recipe["KEYPOINT"]["NUM_PTS"])
        self.geometry = np.random.default_rng(int(traffic["geometry_seed"]))
        self.rng = np.random.default_rng(int(seed))
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device

    def skeletons(self, n: int) -> np.ndarray:
        """(n, J, 3) joints in world mm."""
        s = self.skeleton
        centre = np.asarray(self.skeleton["centre_mm"], dtype=np.float64)
        jitter = self.geometry.uniform(-1.0, 1.0, (n, 1, 3)) * np.asarray(s["jitter_mm"])
        offsets = self.geometry.uniform(-1.0, 1.0, (n, self.joints, 3)) * \
            np.asarray(s["extent_mm"])
        return centre + jitter + offsets

    def view(self, cam: int, X: np.ndarray):
        """(KRT (3, 4), K, RT, points-2d (J, 2)) of camera `cam` on joints X,
        cropped as the traffic file says."""
        K, RT = self.cams["K"][cam], self.cams["RT"][cam]
        P = K @ RT
        xh = np.concatenate([X, np.ones((len(X), 1))], 1) @ P.T
        pts = xh[:, :2] / xh[:, 2:]
        if self.crop:
            lo, hi = pts.min(0), pts.max(0)
            side = self.crop["box_scale"] * float((hi - lo).max())
            H, W = self.image_hw
            scale = W / side
            centre = (lo + hi) / 2.0
            A = np.array([[scale, 0.0, W / 2.0 - scale * centre[0]],
                          [0.0, scale, H / 2.0 - scale * centre[1]], [0.0, 0.0, 1.0]])
            K, P = A @ K, A @ P
            pts = pts * scale + (A[:2, 2])
        return P, K, RT, pts

    def images(self, n: int) -> torch.Tensor:
        """(n, H, W, 3) float32 images on the device."""
        return torch.randn(n, *self.image_hw, 3, generator=self.gen, device=self.device)

    def heatmaps(self, pts: np.ndarray) -> tuple:
        """(n, J, h, w) float32 targets on the device and (n, J) visibility of
        (n, J, 2) joint pixels."""
        H, W = self.image_hw
        vis = ((pts[..., 0] >= 0) & (pts[..., 0] < W) & (pts[..., 1] >= 0) &
               (pts[..., 1] < H)).astype(np.float32)
        h, w = self.heatmap_hw
        s = self.stride
        ys = torch.arange(h, device=self.device, dtype=torch.float32) * s + s / 2.0 - 0.5
        xs = torch.arange(w, device=self.device, dtype=torch.float32) * s + s / 2.0 - 0.5
        p = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        d2 = ((ys[None, None, :, None] - p[..., 1, None, None]) ** 2
              + (xs[None, None, None, :] - p[..., 0, None, None]) ** 2) / (2 * self.sigma ** 2)
        v = torch.as_tensor(vis, device=self.device)
        return torch.exp(-d2.clamp(max=HEATMAP_CLIP)) * v[..., None, None], v


def train_batches(rig: Rig, batch: int, count: int) -> List[Dict[str, torch.Tensor]]:
    """`count` distinct train batches of `batch` items, as the port's model
    takes them (images NCHW over channels_last memory)."""
    X_all = rig.skeletons(batch * count)
    ref_all = rig.geometry.integers(0, rig.views, batch * count)
    order = rig.rng.permutation(batch * count)
    out = []
    for i in range(count):
        items = order[i * batch:(i + 1) * batch]
        X, ref = X_all[items], ref_all[items]
        views = [rig.view(int(c), x) for c, x in zip(ref, X)]
        others = [rig.view(int(rig.nearest[c]), x) for c, x in zip(ref, X)]
        heat, vis = rig.heatmaps(np.stack([v[3] for v in views]))
        dev = rig.device
        out.append({
            "img": rig.images(batch).permute(0, 3, 1, 2),
            "other_img": rig.images(batch).permute(0, 3, 1, 2),
            "KRT": torch.as_tensor(np.stack([v[0] for v in views]), dtype=torch.float32,
                                   device=dev),
            "other_KRT": torch.as_tensor(np.stack([o[0] for o in others]),
                                         dtype=torch.float32, device=dev),
            "heatmap": heat,
            "visibility": vis,
        })
    return out


def infer_groups(rig: Rig, count: int) -> List[Dict[str, np.ndarray]]:
    """`count` view groups on the host, as the port's eval engine takes
    them: every view with its nearest other camera's view, the cameras, the
    3D joints and, for the metrics, the target heatmaps (NHWC) and 2D joints."""
    groups = []
    V = rig.views
    skeletons = rig.skeletons(count)
    for i in rig.rng.permutation(count):
        X = skeletons[i]
        views = [rig.view(c, X) for c in range(V)]
        pts = np.stack([v[3] for v in views])
        heat, vis = rig.heatmaps(pts)
        img = rig.images(V).cpu().numpy()
        nb = rig.nearest
        groups.append({
            "img": img,
            "other_img": img[nb],
            "KRT": np.stack([v[0] for v in views]).astype(np.float32),
            "other_KRT": np.stack([views[o][0] for o in nb]).astype(np.float32),
            "K": np.stack([v[1] for v in views]).astype(np.float32),
            "RT": np.stack([v[2] for v in views]).astype(np.float32),
            "camera": np.arange(V, dtype=np.int32),
            "other_camera": nb.astype(np.int32),
            "points-2d": pts.astype(np.float32),
            "points-3d": X.astype(np.float32),
            "heatmap": heat.permute(0, 2, 3, 1).cpu().numpy(),
            "visibility": vis.cpu().numpy(),
            "action": np.int32(0),
        })
    return groups
