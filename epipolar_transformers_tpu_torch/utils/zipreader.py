"""Images inside .zip archives, by the `path.zip@/member` syntax.

The port's own copy of epipolar_transformers_tpu/utils/zipreader.py
(reference utils/zipreader.py:23-46), decoding through the port's
`read_jpeg` instead of cv2.  Archives are opened once per process: the
handle cache is keyed by (pid, path), because a forked loader worker must
not reuse its parent's handle, whose file offset it would share with the
parent and its siblings.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Tuple

import numpy as np

from ..data.jpeg import read_jpeg

_cache: Dict[Tuple[int, str], zipfile.ZipFile] = {}


def split_zip_path(path: str) -> Tuple[str, str]:
    """'a/b.zip@/c/d.jpg' -> ('a/b.zip', 'c/d.jpg')."""
    pos = path.find(".zip@")
    if pos == -1:
        raise ValueError(f"character '.zip@' not found in {path!r}")
    return path[:pos + 4], path[pos + 5:].lstrip("/")


def imread(path: str) -> np.ndarray:
    """The JPEG at `path.zip@member` as (H, W, 3) uint8 BGR (cv2's
    IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION decode)."""
    zip_path, member = split_zip_path(path)
    key = (os.getpid(), zip_path)
    if key not in _cache:
        _cache[key] = zipfile.ZipFile(zip_path, "r")
    return read_jpeg(_cache[key].read(member), name=path)
