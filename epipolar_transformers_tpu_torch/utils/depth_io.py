"""Depth maps: 16-bit PNG, PGM and TIFF, without cv2.

Port of epipolar_transformers_tpu/utils/depth_io.py (reference
utils/depth_io.py), which reads with cv2.imread(IMREAD_UNCHANGED) and
writes with cv2.imwrite.  The port reads and writes with its own
data/image_io.py: PNG of 8 or 16 bits, PGM (P5, P2) and uncompressed TIFF;
a compressed TIFF raises, naming its compression.  A colour image gives
its first channel in cv2's BGR order, the blue one, as the JAX function
does.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.image_io import read_pgm, read_png, read_tiff, write_png

_READERS = {".png": read_png, ".pgm": read_pgm, ".tif": read_tiff, ".tiff": read_tiff}


def load_depth(path: str, scale: float = 1.0) -> np.ndarray:
    """A depth image as float32 times `scale` (metres when `scale`
    converts the file's units)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext not in _READERS:
        raise ValueError(f"{path}: load_depth reads {sorted(_READERS)}")
    depth = _READERS[ext](path)
    if depth.ndim == 3:
        depth = depth[..., 2]  # cv2's BGR(A) channel 0: the file's blue
    return depth.astype(np.float32) * scale


def rhd_depth_decode(depth_rgb: np.ndarray) -> np.ndarray:
    """RHD packs depth into two uint8 channels: d = (top*256 + bottom)/65535
    (RHD dataset convention)."""
    top = depth_rgb[..., 0].astype(np.float32)
    bottom = depth_rgb[..., 1].astype(np.float32)
    return (top * 256.0 + bottom) / 65535.0


def save_depth_png(path: str, depth: np.ndarray, scale: float = 1000.0) -> None:
    """Store float depth as a 16-bit PNG (mm by default)."""
    write_png(path, np.clip(depth * scale, 0, 65535).astype(np.uint16))
