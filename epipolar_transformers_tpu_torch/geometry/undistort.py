"""Lens undistortion of points and images on the host, in numpy.

The JAX H36M dataset undistorts with cv2 (JAX
data/datasets/joints_dataset.py:38-44, 210); the port carries its own
copies of the two calls, with OpenCV's distortion model (k1, k2, p1, p2,
k3):

  * `undistort_points(pts, K, dist)`: cv2.undistortPoints(pts, K, dist,
    P=K), cv2's 5 fixed-point iterations of x = (x0 - delta(x)) * icdist(x)
    from the normalized distorted point (the JAX CameraModel.undistort
    takes 10, but the dataset calls cv2, so the port follows cv2).
  * `undistort_image(img, K, dist)`: cv2.undistort on uint8 images, that is
    initUndistortRectifyMap(K, dist, I, K, size, CV_16SC2) in the strips of
    rows cv2.undistort computes it in, then remap(INTER_LINEAR,
    BORDER_CONSTANT 0) in cv2's fixed point: the map rounded to 1/32 px,
    the 32x32 table of 4 weights per sub-pixel position that sum to
    1 << 15, (sum w p + (1 << 14)) >> 15 saturated, and taps outside the
    image reading 0.  The maps depend only on (K, dist, size), so the last
    few are cached.  One detail is not copied: where a map coordinate
    falls on an exact 1/64 px tie, cv2's vectorised map arithmetic (fused
    multiply-adds) may round the 1/32 px step the other way; a camera with
    fractional parameters, as H36M's are, meets no such tie.

tests/test_torch_undistort.py holds both to cv2.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = ["undistort_image", "undistort_maps", "undistort_points", "remap_bilinear_u8"]

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
COEF_BITS = 15


def _coeffs(dist) -> Tuple[float, float, float, float, float]:
    d = np.zeros(5)
    flat = np.asarray(dist, np.float64).reshape(-1)
    if len(flat) not in (4, 5):
        raise ValueError(f"distortion coefficients (k1, k2, p1, p2[, k3]), not {len(flat)}")
    d[:len(flat)] = flat
    return tuple(float(v) for v in d)


def undistort_points(pts, K, dist, iterations: int = 5) -> np.ndarray:
    """(N, 2) distorted pixel points -> (N, 2) undistorted pixel points in
    the same camera, as cv2.undistortPoints(pts, K, dist, P=K) computes
    them (float64)."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = _coeffs(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (pts[:, 0] - cx) * (1.0 / fx)
    y0 = (pts[:, 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    done = np.zeros(len(pts), bool)
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        # cv2 stops a point whose icdist turns negative at its undistorted
        # normalized coordinates
        neg = (icdist < 0) & ~done
        x[neg], y[neg] = x0[neg], y0[neg]
        done |= neg
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    return np.stack([fx * x + cx, fy * y + cy], axis=1)


def _inv3(m: np.ndarray) -> np.ndarray:
    """cv::invert(DECOMP_LU) of a 3x3 double matrix: the adjugate over the
    determinant, as OpenCV's small-matrix path computes it."""
    d = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
         - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
         + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    d = 1.0 / d
    return np.array([
        [(m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d, (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
         (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d],
        [(m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d, (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
         (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d],
        [(m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d, (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
         (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d]])


def _map(K: np.ndarray, coeffs, width: int, height: int):
    """initUndistortRectifyMap's (u, v) source coordinates (R = I, new
    camera K), float64, as cv2.undistort computes them: in strips of
    max(1, 4096 // width) rows, each with the new camera's principal point
    moved to the strip's first row (v0 - y), so that row i of a strip
    starting at row s reads the inverse of that shifted camera."""
    k1, k2, p1, p2, k3 = coeffs
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    strip = min(max(1, 4096 // max(width, 1)), height)
    rows = np.arange(height)
    start = (rows // strip) * strip
    ir = _inv3(K).reshape(-1)
    # of the inverse, only its (1, 2) entry depends on the principal point's row
    det = 1.0 / (K[0, 0] * (K[1, 1] * K[2, 2] - K[1, 2] * K[2, 1])
                 - K[0, 1] * (K[1, 0] * K[2, 2] - K[1, 2] * K[2, 0])
                 + K[0, 2] * (K[1, 0] * K[2, 1] - K[1, 1] * K[2, 0]))
    ir5 = (K[0, 2] * K[1, 0] - K[0, 0] * (v0 - start)) * det
    i = (rows - start).astype(np.float64)[:, None]
    j = np.arange(width, dtype=np.float64)[None, :]
    _x = i * ir[1] + ir[2] + j * ir[0]
    _y = i * ir[4] + ir5[:, None] + j * ir[3]
    _w = i * ir[7] + ir[8] + j * ir[6]
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u, v


@functools.lru_cache(maxsize=8)
def _maps_cached(K_bytes: bytes, dist_bytes: bytes, size: Tuple[int, int]):
    K = np.frombuffer(K_bytes, np.float64).reshape(3, 3)
    coeffs = tuple(np.frombuffer(dist_bytes, np.float64).tolist())
    u, v = _map(K, coeffs, int(size[0]), int(size[1]))
    iu = np.clip(np.rint(u * INTER_TAB_SIZE), -2 ** 31, 2 ** 31 - 1).astype(np.int64)
    iv = np.clip(np.rint(v * INTER_TAB_SIZE), -2 ** 31, 2 ** 31 - 1).astype(np.int64)
    # the integer source pixel saturates to int16, as cv2 stores it
    xy = np.clip(np.stack([iu >> INTER_BITS, iv >> INTER_BITS], axis=-1), -32768, 32767
                 ).astype(np.int16)
    fxy = ((iv & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE + (iu & (INTER_TAB_SIZE - 1))
           ).astype(np.uint16)
    xy.setflags(write=False)
    fxy.setflags(write=False)
    return xy, fxy


def undistort_maps(K, dist, size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.undistort's fixed-point maps for a (width, height) image: (H, W,
    2) int16 integer source pixels (x, y) and (H, W) uint16 sub-pixel table
    indices (CV_16SC2 with its CV_16UC1 companion).  Read-only, cached."""
    K = np.ascontiguousarray(K, np.float64).reshape(3, 3)
    coeffs = np.asarray(_coeffs(dist), np.float64)
    return _maps_cached(K.tobytes(), coeffs.tobytes(), (int(size[0]), int(size[1])))


def _weight_table() -> np.ndarray:
    """initInterTab2D(INTER_LINEAR, fixed point): (1024, 4) int32 weights
    of the taps (y0 x0, y0 x1, y1 x0, y1 x1) per sub-pixel index, each
    rounded from float, the 4 adjusted to sum to exactly 1 << 15."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.float32) * np.float32(1.0 / INTER_TAB_SIZE)
    one = np.stack([np.float32(1) - t, t], axis=1)  # (32, 2)
    w = (one[:, None, :, None] * one[None, :, None, :])  # (iy, ix, ky, kx)
    w = np.rint(w.astype(np.float32) * np.float32(1 << COEF_BITS)).astype(np.int64)
    w = np.minimum(w, 32767).reshape(INTER_TAB_SIZE * INTER_TAB_SIZE, 4)
    diff = w.sum(1) - (1 << COEF_BITS)
    for row in np.flatnonzero(diff):
        # OpenCV moves the difference onto the tap with the largest (sum too
        # small) or smallest (too large) weight
        k = int(np.argmax(w[row])) if diff[row] < 0 else int(np.argmin(w[row]))
        w[row, k] -= diff[row]
    return w.astype(np.int32)


_WEIGHTS = _weight_table()


def remap_bilinear_u8(img: np.ndarray, xy: np.ndarray, fxy: np.ndarray) -> np.ndarray:
    """cv2.remap(img, xy, fxy, INTER_LINEAR, BORDER_CONSTANT 0) for a uint8
    (H, W[, C]) image and fixed-point maps."""
    src = np.asarray(img, np.uint8)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    H, W, C = src.shape
    x0 = xy[..., 0].reshape(-1).astype(np.int64)
    y0 = xy[..., 1].reshape(-1).astype(np.int64)
    w = _WEIGHTS[fxy.reshape(-1)]
    # the image inside a zero frame, 1 pixel wide before it and 2 after:
    # every tap of a 2x2 that touches the image reads its pixel or a 0, and
    # a 2x2 wholly outside reads the zeros at the far corner
    Wp = W + 3
    corner = (H + 1) * Wp + W + 1
    touches = (x0 >= -1) & (x0 < W) & (y0 >= -1) & (y0 < H)
    base = np.where(touches, (y0 + 1) * Wp + x0 + 1, corner)
    taps = (base, base + 1, base + Wp, base + Wp + 1)
    out = np.empty((len(base), C), np.uint8)
    padded = np.zeros((H + 3, Wp), np.int32)
    for c in range(C):
        padded[1:H + 1, 1:W + 1] = src[..., c]
        flat = padded.reshape(-1)
        acc = sum(np.take(flat, t) * w[:, k] for k, t in enumerate(taps))
        out[:, c] = np.clip((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS, 0, 255)
    out = out.reshape(xy.shape[:2] + (C,))
    return out[..., 0] if squeeze else out


def undistort_image(img: np.ndarray, K, dist) -> np.ndarray:
    """cv2.undistort(img, K, dist) of a uint8 (H, W[, C]) image."""
    H, W = img.shape[:2]
    xy, fxy = undistort_maps(K, dist, (W, H))
    return remap_bilinear_u8(img, xy, fxy)
