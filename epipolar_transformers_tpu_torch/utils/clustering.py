"""Color quantization via k-means (reference utils/clustering.py used faiss;
this is a dependency-free numpy Lloyd's iteration — the aux path only
quantizes image colors for the rgb-correspondence experiments,
reference data/transforms/image.py:122-169).

The port's own copy of epipolar_transformers_tpu/utils/clustering.py."""

from __future__ import annotations

import numpy as np


def kmeans(data: np.ndarray, k: int, iters: int = 20, seed: int = 0):
    """Lloyd's k-means. data (N, D) -> (centroids (k, D), labels (N,))."""
    rng = np.random.RandomState(seed)
    data = np.asarray(data, dtype=np.float32)
    centroids = data[rng.choice(len(data), k, replace=False)].copy()
    labels = np.zeros(len(data), dtype=np.int32)
    for _ in range(iters):
        d2 = ((data[:, None, :] - centroids[None]) ** 2).sum(-1)
        new_labels = np.argmin(d2, axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            mask = labels == c
            if mask.any():
                centroids[c] = data[mask].mean(0)
    return centroids, labels


def quantize_image(img_hwc: np.ndarray, k: int = 8, seed: int = 0) -> np.ndarray:
    """Map every pixel to its nearest of k color centroids."""
    H, W, C = img_hwc.shape
    flat = img_hwc.reshape(-1, C)
    centroids, labels = kmeans(flat, k, seed=seed)
    return centroids[labels].reshape(H, W, C)
