"""Offline visualization and introspection, with no cv2 and no PIL.

Port of epipolar_transformers_tpu/vis/visualization.py (reference
vision/visualization.py:319-643 and scripts/video.py):
  * pointcloud export: saved eval predictions -> one pickle a sample;
  * epipolar-line introspection: a live Epipolar layer on a batch, its
    sample locations, attention weights and correspondences dumped;
  * AUC curves from accumulated PCK counts;
  * the eval frame dumps (skeletons drawn over each view) and the video
    that stitches them side by side;
  * the lifting tasks' 3D hand comparison panels (matplotlib, imported
    when used, as in the JAX module).

Where the JAX module draws and writes with cv2, the port has its own:
  * `draw_line_aa` / `draw_disc_aa`: anti-aliased lines (clipped to the
    image as cv2 clips them) and filled discs, coverage by distance from
    the pixel centre, blended and rounded.  They touch the pixels cv2's
    LINE_AA touches to within one pixel (tests/test_torch_vis.py);
  * PNG through data/image_io.write_png;
  * the video as a RIFF AVI of uncompressed 24-bit frames (BI_RGB), which
    `read_avi` reads back bit for bit.  The JAX module writes mp4v through
    cv2.VideoWriter; the card's machine has no encoder, and an
    uncompressed AVI is lossless and needs none (MJPEG through
    data/jpeg.encode_jpeg would be smaller, but lossy).

All functions are headless: they write files rather than open windows.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.image_io import read_png, write_png
from ..data.transforms.affine import de_normalize_image
from ..utils.file_utils import pred_pickle_path
from .skeletons import CONNECTIVITY_DICT, HAND_BONES

_EPS = 2.0 ** -16  # cv2 clips a line to [0, W) x [0, H) in 16-bit fixed point


# ------------------------------------------------------------------ raster

def _blend(frame: np.ndarray, y0: int, x0: int, alpha: np.ndarray, color) -> None:
    h, w = alpha.shape
    region = frame[y0:y0 + h, x0:x0 + w].astype(np.float64)
    a = alpha[..., None]
    frame[y0:y0 + h, x0:x0 + w] = np.rint(region * (1.0 - a)
                                          + np.asarray(color, np.float64) * a).astype(np.uint8)


def _clip_segment(p0, p1, W: int, H: int):
    """Liang-Barsky: the part of p0-p1 inside [0, W) x [0, H), or None."""
    (x0, y0), (x1, y1) = (float(v) for v in p0), (float(v) for v in p1)
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, W - _EPS - x0), (-dy, y0), (dy, H - _EPS - y0)):
        if p == 0:
            if q < 0:
                return None
        elif p < 0:
            t0 = max(t0, q / p)
        else:
            t1 = min(t1, q / p)
    if t0 > t1:
        return None
    return (x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy)


def _window(frame, lo_x, hi_x, lo_y, hi_y):
    H, W = frame.shape[:2]
    lo_x, hi_x, lo_y, hi_y = max(lo_x, 0), min(hi_x, W), max(lo_y, 0), min(hi_y, H)
    if lo_x >= hi_x or lo_y >= hi_y:
        return None
    ys, xs = np.mgrid[lo_y:hi_y, lo_x:hi_x].astype(np.float64)
    return lo_x, lo_y, xs, ys


def draw_line_aa(frame: np.ndarray, p0, p1, color) -> None:
    """An anti-aliased line one pixel wide from p0 to p1 ((x, y)), in place:
    each pixel takes 1 - its centre's distance to the segment of color."""
    H, W = frame.shape[:2]
    seg = _clip_segment(p0, p1, W, H)
    if seg is None:
        return
    (x0, y0), (x1, y1) = seg
    win = _window(frame, int(np.floor(min(x0, x1))) - 2, int(np.ceil(max(x0, x1))) + 3,
                  int(np.floor(min(y0, y1))) - 2, int(np.ceil(max(y0, y1))) + 3)
    if win is None:
        return
    lo_x, lo_y, xs, ys = win
    dx, dy = x1 - x0, y1 - y0
    n2 = dx * dx + dy * dy
    t = (np.clip(((xs - x0) * dx + (ys - y0) * dy) / n2, 0.0, 1.0) if n2 > 0
         else np.zeros_like(xs))
    d = np.hypot(xs - (x0 + t * dx), ys - (y0 + t * dy))
    _blend(frame, lo_y, lo_x, np.clip(1.0 - d, 0.0, 1.0), color)


def draw_disc_aa(frame: np.ndarray, center, radius: int, color) -> None:
    """A filled anti-aliased disc, in place: a pixel takes radius + 0.5 -
    its centre's distance to `center`, clipped to [0, 1], of color."""
    cx, cy = int(center[0]), int(center[1])
    win = _window(frame, cx - radius - 2, cx + radius + 3, cy - radius - 2, cy + radius + 3)
    if win is None:
        return
    lo_x, lo_y, xs, ys = win
    d = np.hypot(xs - cx, ys - cy)
    _blend(frame, lo_y, lo_x, np.clip(radius + 0.5 - d, 0.0, 1.0), color)


# ------------------------------------------------------------------ the video container

def _riff(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + (b"\0" if len(body) % 2 else b"")


def _riff_list(kind: bytes, body: bytes) -> bytes:
    return _riff(b"LIST", kind + body)


def write_avi(path: str, frames: Sequence[np.ndarray], fps: int = 10) -> None:
    """Uncompressed 24-bit AVI (BI_RGB, top-down rows padded to 4 bytes: a
    negative height) of (H, W, 3) uint8 BGR frames, one video stream, with
    an idx1 index."""
    h, w = frames[0].shape[:2]
    stride = (w * 3 + 3) & ~3
    size = stride * h
    chunks, index, offset = [], [], 4  # offsets count from 'movi'
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"write_avi: frame {f.shape} {f.dtype}, expected ({h}, {w}, 3) uint8")
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :w * 3] = f.reshape(h, w * 3)
        chunk = _riff(b"00db", rows.tobytes())
        index.append(struct.pack("<4sIII", b"00db", 0x10, offset, size))  # AVIIF_KEYFRAME
        chunks.append(chunk)
        offset += len(chunk)
    n = len(frames)
    avih = struct.pack("<IIIIIIIIII4I", 1000000 // fps, size * fps, 0, 0x10, n, 0, 1, size,
                       w, h, 0, 0, 0, 0)  # AVIF_HASINDEX
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n, size,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _riff_list(b"hdrl", _riff(b"avih", avih)
                      + _riff_list(b"strl", _riff(b"strh", strh) + _riff(b"strf", strf)))
    movi = _riff_list(b"movi", b"".join(chunks))
    with open(path, "wb") as fh:
        fh.write(_riff(b"RIFF", b"AVI " + hdrl + movi + _riff(b"idx1", b"".join(index))))


def read_avi(path: str) -> List[np.ndarray]:
    """The frames of an uncompressed 24-bit AVI that `write_avi` wrote, as
    (H, W, 3) uint8 BGR."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    w = h = None
    frames, pos, end = [], 12, len(data)
    stack = []
    while pos + 8 <= end:
        kind, size = struct.unpack("<4sI", data[pos:pos + 8])
        body = pos + 8
        if kind == b"LIST":
            stack.append(end)
            pos, end = body + 4, body + size
            continue
        if kind == b"strf":
            _, w, h, _, bits, compression = struct.unpack("<IiiHHI", data[body:body + 20])
            if bits != 24 or compression != 0:
                raise ValueError(f"{path}: {bits}-bit frames, compression {compression}; "
                                 "read_avi reads uncompressed 24-bit ones")
        elif kind in (b"00db", b"00dc"):
            stride = (w * 3 + 3) & ~3
            rows = np.frombuffer(data, np.uint8, stride * abs(h), body).reshape(abs(h), stride)
            frame = rows[:, :w * 3].reshape(abs(h), w, 3)
            frames.append(np.ascontiguousarray(frame[::-1] if h > 0 else frame))
        pos = body + size + (size & 1)
        while pos >= end and stack:
            pos, end = end, stack.pop()
    return frames


# ------------------------------------------------------------------ dumps

def export_pointclouds(predictions_path: str, out_dir: str, limit: int = -1) -> int:
    """Eval prediction dumps -> one pickle a sample (reference
    visualization.py:320-466 stores {pred3d, gt3d, locs, scos})."""
    with open(predictions_path, "rb") as f:
        preds = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    n = len(preds) if limit < 0 else min(limit, len(preds))
    for i in range(n):
        with open(os.path.join(out_dir, f"pointcloud_{i:05d}.pkl"), "wb") as f:
            pickle.dump(preds[i], f)
    return n


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).permute(0, 3, 1, 2)


def epipolar_introspection(cfg, layer: torch.nn.Module, batch: Dict[str, np.ndarray],
                           out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Run an Epipolar layer (models/epipolar.py) in eval mode on features
    and dump every geometric intermediate (reference Epipolar(debug=True),
    epipolar.py:264-265, visualization.py:472-537): sample_locs (N, K, H,
    W, 2), corr_pos (N, H, W, 2), attention (N, K', H, W) and the fused
    features, channels-last as the JAX dump has them.  `batch`: feat and
    other_feat (N, H, W, C), KRT and other_KRT (N, 3, 4)."""
    device = next(iter(layer.parameters()), torch.zeros(())).device
    layer.eval()
    with torch.no_grad():
        fused, corr_pos, depth, sample_locs = layer(
            _nchw(batch["feat"], device), _nchw(batch["other_feat"], device),
            torch.as_tensor(np.asarray(batch["KRT"], np.float32), device=device),
            torch.as_tensor(np.asarray(batch["other_KRT"], np.float32), device=device))
    dump = {"sample_locs": sample_locs.cpu().numpy(), "corr_pos": corr_pos.cpu().numpy(),
            "attention": depth.float().cpu().numpy(),
            "fused": fused.permute(0, 2, 3, 1).float().cpu().numpy()}
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(dump, f)
    return dump


def auc_curve(err_joints: np.ndarray, total_joints: np.ndarray, max_threshold: float):
    """Accumulated per-image error counts -> (thresholds, accuracy, AUC)
    (reference visualization.py:178-190, metrics2d.py:111-116)."""
    thresholds = np.linspace(0, max_threshold, num=int(max_threshold))
    acc = err_joints.sum(axis=0) / max(total_joints.sum(), 1)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    auc = trapezoid(acc, thresholds) / max_threshold
    return thresholds, acc, float(auc)


def render_pose_frame(img_norm: np.ndarray, joints: np.ndarray, kind: str = "human36m",
                      visibility: Optional[np.ndarray] = None) -> np.ndarray:
    """A skeleton drawn over one view, uint8 BGR, for the eval video dump
    (reference tester.py:138-166): green anti-aliased bones, red discs of
    radius 2 on the joints.

    Args:
        img_norm: (H, W, 3) ImageNet-normalized float image (dataset 'img').
        joints: (J, 2) image-coordinate keypoints.
        kind: CONNECTIVITY_DICT key, or 'hand' for the 21-joint bones.
    """
    img = np.clip(de_normalize_image(np.asarray(img_norm)) * 255, 0, 255)
    frame = np.ascontiguousarray(img.astype(np.uint8)[..., ::-1])  # RGB -> BGR
    bones = ([b for finger in HAND_BONES for b in finger] if kind == "hand"
             else CONNECTIVITY_DICT[kind])
    joints = np.asarray(joints)
    vis = (np.asarray(visibility).reshape(-1) > 0 if visibility is not None
           else np.ones(len(joints), bool))
    for a, b in bones:
        if a < len(joints) and b < len(joints) and vis[a] and vis[b]:
            draw_line_aa(frame, np.int32(joints[a]), np.int32(joints[b]), (0, 255, 0))
    for j, (x, y) in enumerate(joints):
        if vis[j]:
            draw_disc_aa(frame, (int(x), int(y)), 2, (0, 0, 255))
    return frame


def write_frame(path: str, bgr: np.ndarray) -> None:
    """A BGR frame as a PNG (what cv2.imwrite writes of it)."""
    write_png(path, bgr[..., ::-1])


def read_frame(path: str) -> np.ndarray:
    """A PNG frame as BGR (what cv2.imread reads of it)."""
    return np.ascontiguousarray(read_png(path)[..., 2::-1])


def dump_eval_frames(cfg, group: Dict[str, np.ndarray], locs: np.ndarray, dataset_tag: str,
                     idx: int) -> int:
    """The per-view frames of one eval group (reference tester.py:138-166):
    OUTPUT_DIR/video/<dataset>/view<k>/%08d.png, which `assemble_video`
    stitches afterwards.  Returns the frames written."""
    if not cfg.OUTPUT_DIR:
        return 0
    imgs = np.asarray(group["img"])
    if imgs.ndim == 3:
        imgs = imgs[None]
    locs = np.asarray(locs)
    if locs.ndim == 2:
        locs = locs[None]
    kind = "hand" if cfg.LIFTING.ENABLED else (
        "human36m" if cfg.KEYPOINT.NUM_PTS in (17, 20) else "mpii")
    vis = group.get("visibility")
    n = 0
    for v in range(imgs.shape[0]):
        vvis = None if vis is None else np.asarray(vis)[v] if np.asarray(vis).ndim > 1 else vis
        frame = render_pose_frame(imgs[v], locs[v], kind=kind, visibility=vvis)
        out_dir = os.path.join(cfg.OUTPUT_DIR, "video", dataset_tag, f"view{v}")
        os.makedirs(out_dir, exist_ok=True)
        write_frame(os.path.join(out_dir, f"{idx:08d}.png"), frame)
        n += 1
    return n


def dump_epipolar_debug_pair(cfg, ret: Dict[str, np.ndarray], idx: int) -> Optional[str]:
    """VIS.MULTIVIEWH36M: the reference's in-dataset debug view
    (multiview_h36m.py:159-243), headless: the reference and other frames
    side by side with the ground-truth 2D keypoints (red), the ground-truth
    3D reprojected into the other view, and the epipolar lines of a probe
    column through the fundamental matrix.  Written to
    OUTPUT_DIR/debug_multiview/%08d.png."""
    if not cfg.OUTPUT_DIR:
        return None
    from ..geometry.camera import fundamental_matrix

    def bgr(img):
        return np.ascontiguousarray(np.clip(de_normalize_image(np.asarray(img)) * 255, 0, 255)
                                    .astype(np.uint8)[..., ::-1])

    f1, f2 = bgr(ret["img"]), bgr(ret["other_img"])
    H, W = f1.shape[:2]
    P1 = np.asarray(ret["KRT"], np.float64)
    P2 = np.asarray(ret["other_KRT"], np.float64)
    F = fundamental_matrix(torch.from_numpy(P1), torch.from_numpy(P2)).numpy()

    for x, y in np.asarray(ret["points-2d"]).reshape(-1, 2):
        draw_disc_aa(f1, (int(x), int(y)), 3, (0, 0, 255))
    if "points-3d" in ret:
        X = np.asarray(ret["points-3d"], np.float64).reshape(-1, 3)
        proj = P2 @ np.concatenate([X, np.ones((len(X), 1))], 1).T
        for x, y in (proj[:2] / proj[2]).T:
            if np.isfinite([x, y]).all():
                draw_disc_aa(f2, (int(x), int(y)), 3, (0, 0, 255))

    # a probe column of view 1 -> its epipolar lines in view 2 (the
    # reference's test points at x = W/2, y in a linspace)
    n = 8
    probes = np.stack([np.full(n, W // 2), np.linspace(10, H - 10, n), np.ones(n)], axis=1)
    lim = 32 * max(H, W)  # F's scale is arbitrary: keep near-vertical lines finite
    for i, line in enumerate((F @ probes.T).T):
        if abs(line[1]) < 1e-12:
            continue
        x0, x1 = 0, W - 1
        y0 = int(np.clip((-line[2] - line[0] * x0) / line[1], -lim, lim))
        y1 = int(np.clip((-line[2] - line[0] * x1) / line[1], -lim, lim))
        color = (60 + 24 * i, 255 - 24 * i, 80)
        draw_line_aa(f2, (x0, y0), (x1, y1), color)
        draw_disc_aa(f1, (int(probes[i, 0]), int(probes[i, 1])), 3, color)

    out_dir = os.path.join(cfg.OUTPUT_DIR, "debug_multiview")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{idx:08d}.png")
    write_frame(path, np.concatenate([f1, f2], axis=1))
    return path


def hand_comparison_panels(predictions_path: str, out_dir: str, limit: int = -1) -> int:
    """3D hand prediction-against-ground-truth panels, one PNG a sample,
    the reference's default visualization mode (visualization.py:545-643):
    canonical ground truth, prediction and overlay on the top row, the
    view-normed ones below, at the camera-aligned view (azim -90, elev
    -90).  Needs matplotlib.  Returns the panels written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .skeletons import plot_hand_3d

    with open(predictions_path, "rb") as f:
        preds = pickle.load(f)
    os.makedirs(out_dir, exist_ok=True)
    n = len(preds) if limit < 0 else min(limit, len(preds))
    for i in range(n):
        inputs, pred = preds[i]
        vis = np.asarray(inputs["visibility"]).reshape(-1)[:, None]
        can_gt = np.asarray(inputs["can-points-3d"]) * vis
        can_pred = np.asarray(pred["can_pred"]) * vis
        panels = [("canonical GT", [can_gt]), ("canonical pred", [can_pred]),
                  ("canonical overlay", [can_gt, can_pred])]
        if "normed_pred" in pred and "normed-points-3d" in inputs:
            normed_gt = np.asarray(inputs["normed-points-3d"]) * vis
            normed_pred = np.asarray(pred["normed_pred"]) * vis
            panels += [("normed GT", [normed_gt]), ("normed pred", [normed_pred]),
                       ("normed overlay", [normed_gt, normed_pred])]
        rows = -(-len(panels) // 3)
        fig = plt.figure(figsize=(9, 3 * rows))
        occ = vis[:, 0] > 0
        for p, (title, hands) in enumerate(panels):
            ax = fig.add_subplot(rows, 3, p + 1, projection="3d")
            for h, coords in enumerate(hands):
                # overlay: the ground truth grey, the prediction by finger
                plot_hand_3d(coords, ax, occlusion=occ,
                             color_fixed="0.6" if (len(hands) > 1 and h == 0) else None)
            ax.view_init(azim=-90.0, elev=-90.0)  # camera-aligned, reference :617
            ax.set_title(title, fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"hand_panel_{i:05d}.png"), dpi=80)
        plt.close(fig)
    return n


def assemble_video(frame_dirs: Sequence[str], out_path: str, fps: int = 10,
                   grid_cols: int = 2) -> int:
    """One AVI of the per-view frame directories side by side, `grid_cols`
    views a row (reference scripts/video.py:44-125).  Returns the frames."""
    frame_lists = [sorted(os.listdir(d)) for d in frame_dirs]
    n_frames = min(len(fl) for fl in frame_lists)
    if n_frames == 0:
        raise ValueError(f"no frames under {list(frame_dirs)}")
    h, w = read_frame(os.path.join(frame_dirs[0], frame_lists[0][0])).shape[:2]
    rows = -(-len(frame_dirs) // grid_cols)
    canvases = []
    for i in range(n_frames):
        canvas = np.zeros((h * rows, w * grid_cols, 3), np.uint8)
        for v, (d, fl) in enumerate(zip(frame_dirs, frame_lists)):
            r, c = divmod(v, grid_cols)
            canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = read_frame(os.path.join(d, fl[i]))
        canvases.append(canvas)
    write_avi(out_path, canvases, fps)
    return n_frames


# ------------------------------------------------------------------ the dispatch

def introspection_layer(cfg, channels: int, device, generator: torch.Generator):
    """The Epipolar layer that `visualization` introspects, on features of
    `channels` channels (the heatmaps' joints).  flax infers a convolution's
    input width at init, so the JAX layer's theta/phi/g read `channels` and
    its z the attention's output, whatever KEYPOINT.NFEATS says; the port
    builds them at those widths, and routes the attention by them (17
    channels are no kernel width: the plain path, as in JAX).  The weights
    are the fusion's initializers (lecun-normal 1x1 convolutions, zero
    biases, the zero-init BN, the prior's U[0, 0.1)), drawn from
    `generator` on the CPU where the JAX package draws from PRNGKey(0)."""
    from ..models.epipolar import Epipolar
    from ..models.layers import Conv2d
    from ..models.resnet import _truncated_normal_

    layer = Epipolar(cfg)
    e = cfg.EPIPOLAR
    widths = {}
    for name in ("theta", "phi", "g"):
        if hasattr(layer, name):
            widths[name] = channels
    value = layer.g.out_channels if hasattr(layer, "g") else channels
    if hasattr(layer, "z"):
        widths["z"] = value
    for name, width in widths.items():
        old = getattr(layer, name)
        setattr(layer, name, Conv2d(width, old.out_channels, 1, bias=True,
                                    dtype=old.compute_dtype))
    rgb = e.FIND_CORR == "rgb"
    query = 3 if rgb else layer.theta.out_channels if hasattr(layer, "theta") else channels
    key = 3 if rgb else layer.phi.out_channels if hasattr(layer, "phi") else channels
    layer.route = layer._route({query, key, value})
    with torch.no_grad():
        for m in layer.modules():
            if isinstance(m, Conv2d):
                _truncated_normal_(m.weight, 1.0, m.weight[0].numel(), generator)
                m.bias.zero_()
        layer.init_weights(generator)
    return layer.to(device)


def _run_epipolar_introspection(cfg, device, generator: torch.Generator):
    """A live Epipolar layer on the first eval group's heatmaps, every
    geometric intermediate dumped (reference visualization.py:472-537)."""
    from ..data.pipeline import make_eval_loaders

    batch = next(iter(make_eval_loaders(cfg)[0]))
    group = {k: np.asarray(v)[0] for k, v in batch.items()}
    feat1 = np.asarray(group["heatmap"], np.float32)
    feat2 = np.asarray(group.get("other_heatmap", group["heatmap"]), np.float32)
    if feat1.ndim == 3:
        feat1, feat2 = feat1[None], feat2[None]
    P1 = np.asarray(group["KRT"], np.float32).reshape(-1, 3, 4)[:1]
    P2 = np.asarray(group["other_KRT"], np.float32).reshape(-1, 3, 4)[:1]
    layer = introspection_layer(cfg, feat1.shape[-1], device, generator)
    out_dir = cfg.OUTPUT_DIR or "."
    os.makedirs(out_dir, exist_ok=True)
    dump = epipolar_introspection(
        cfg, layer, {"feat": feat1[:1], "other_feat": feat2[:1], "KRT": P1, "other_KRT": P2},
        out_path=os.path.join(out_dir, "epipolar_introspection.pkl"))
    return {k: np.asarray(v).shape for k, v in dump.items()}


def visualization(cfg, device=None) -> Dict[str, object]:
    """The command line's VIS dispatch (reference main.py:65-72,
    vision/visualization.py:319-643), by the VIS.* flags:

      POINTCLOUD             saved eval predictions -> one pickle a sample
      EPIPOLAR_LINE / CURSOR a live Epipolar layer's intermediates on a
                             batch, on `device` (cuda:0 by default), its
                             weights from a torch.Generator seeded with
                             cfg.SEED
      AUC                    accumulated PCK counts -> the AUC curve file
      VIDEO                  the eval frame dumps -> one AVI a dataset
      (lifting tasks)        3D hand panels from the saved predictions

    Returns what was produced (empty when no flag is set)."""
    produced: Dict[str, object] = {}
    out_dir = cfg.OUTPUT_DIR or "."

    if cfg.LIFTING.ENABLED:
        pred_path = pred_pickle_path(cfg, out_dir)
        if os.path.isfile(pred_path):
            produced["hand_panels"] = hand_comparison_panels(
                pred_path, os.path.join(out_dir, "hand_panels"), cfg.VIS.SAVE_PRED_LIMIT)

    if cfg.VIS.POINTCLOUD:
        produced["pointclouds"] = export_pointclouds(
            pred_pickle_path(cfg, out_dir), os.path.join(out_dir, "pointclouds"),
            cfg.VIS.SAVE_PRED_LIMIT)

    if cfg.VIS.EPIPOLAR_LINE or cfg.VIS.CURSOR:
        from ..engine.trainer import resolve_device

        produced["epipolar_introspection"] = _run_epipolar_introspection(
            cfg, resolve_device(device), torch.Generator().manual_seed(cfg.SEED))

    if cfg.VIS.AUC:
        with open(os.path.join(out_dir, "pck.pkl"), "rb") as f:
            pck = pickle.load(f)
        thresholds, acc, auc = auc_curve(pck["err_joints"], pck["total_joints"],
                                         cfg.TEST.MAX_TH)
        with open(os.path.join(out_dir, "auc.pkl"), "wb") as f:
            pickle.dump({"thresholds": thresholds, "acc": acc, "auc": auc}, f)
        produced["auc"] = auc

    if cfg.VIS.VIDEO:
        video_root = os.path.join(out_dir, "video")
        # a previous run's <tag>.avi files lie beside the tag directories
        tags = ([t for t in sorted(os.listdir(video_root))
                 if os.path.isdir(os.path.join(video_root, t))]
                if os.path.isdir(video_root) else [])
        for tag in tags:
            view_dirs = sorted(os.path.join(video_root, tag, d)
                               for d in os.listdir(os.path.join(video_root, tag))
                               if d.startswith("view"))
            if view_dirs:
                produced[f"video/{tag}"] = assemble_video(
                    view_dirs, os.path.join(video_root, f"{tag}.avi"))
    return produced
