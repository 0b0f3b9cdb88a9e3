#!/usr/bin/env python3
"""Precompute undistorted H36M frames into `undistoredimages.zip`, with no cv2.

    python3 scripts/torch_undistort_h36m.py --root datasets \
        --anno datasets/h36m/annot/h36m_train.pkl [--out FILE.zip] [--limit N] [--quality 95]

The counterpart of scripts/undistort_h36m.py (reference
scripts/undistort_h36m.py): DATASETS.DATA_FORMAT 'undistoredzip' reads the
frames from this zip, so the loader skips the undistortion of each
1000x1000 frame.  Each record's frame (`<root>/<source>/images/<image>`)
is decoded by the port's JPEG decoder (data/jpeg.py, bit-equal to
cv2.imread), cut to its first 1000 rows, undistorted by
geometry/undistort.py (bit-equal to cv2.undistort) with the record's
camera (k1, k2, p1, p2, k3), encoded by the port's baseline encoder at
`--quality` and stored under `images/<image>`.  Members already in the zip
are kept.  The JAX script remaps with float maps and encodes with cv2, so
the bytes differ; tests/test_torch_vis.py bounds the decoded pixels.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import zipfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epipolar_transformers_tpu_torch.data.jpeg import encode_jpeg, read_jpeg  # noqa: E402
from epipolar_transformers_tpu_torch.geometry.undistort import undistort_image  # noqa: E402


def camera_intrinsics(cam: dict):
    """(K, dist) of an H36M record's camera, dist as (k1, k2, p1, p2, k3)."""
    K = np.array([[float(cam["fx"]), 0.0, float(cam["cx"])],
                  [0.0, float(cam["fy"]), float(cam["cy"])],
                  [0.0, 0.0, 1.0]])
    k = np.asarray(cam["k"], np.float64).reshape(-1)
    p = np.asarray(cam["p"], np.float64).reshape(-1)
    return K, np.array([k[0], k[1], p[0], p[1], k[2]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default="datasets")
    ap.add_argument("--anno", required=True)
    ap.add_argument("--out", default=None,
                    help="output zip (default: <root>/h36m/undistoredimages.zip)")
    ap.add_argument("--limit", type=int, default=-1)
    ap.add_argument("--quality", type=int, default=95)
    args = ap.parse_args(argv)

    with open(args.anno, "rb") as f:
        db = pickle.load(f)
    out_path = args.out or os.path.join(args.root, "h36m", "undistoredimages.zip")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with zipfile.ZipFile(out_path, "a", zipfile.ZIP_STORED) as zf:
        existing = set(zf.namelist())
        for rec in db:
            if 0 <= args.limit <= n:
                break
            member = os.path.join("images", rec["image"])
            if member in existing:
                continue
            src = os.path.join(args.root, rec["source"], "images", rec["image"])
            if not os.path.exists(src):
                continue
            K, dist = camera_intrinsics(rec["camera"])
            frame = undistort_image(np.ascontiguousarray(read_jpeg(src)[:1000]), K, dist)
            zf.writestr(member, encode_jpeg(frame, args.quality))
            existing.add(member)
            n += 1
    print(f"wrote {n} undistorted images to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
